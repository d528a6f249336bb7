"""Device meshes of the port (``repro.launch.mesh``'s serving half).

:func:`make_batch_mesh` gives the serving path its mesh: one device, or
inside a rank of a ``torch.distributed`` process group
(:func:`repro_torch.parallel.dist.spawn_ranks`) the first N ranks, each on
its own device. The training meshes (``make_production_mesh``,
``make_host_mesh``) come with the training half of ROADMAP.md queue 1,
"Sharding over several devices".
"""
from __future__ import annotations

from typing import Optional


def make_batch_mesh(n_devices: Optional[int] = None, device=None, backend: Optional[str] = None):
    """The serving mesh (see :func:`repro_torch.parallel.batch.make_batch_mesh`)."""
    from repro_torch.parallel.batch import make_batch_mesh as _make

    return _make(n_devices, device, backend)
