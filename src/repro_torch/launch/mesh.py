"""Device meshes of the port (``repro.launch.mesh``'s serving half).

:func:`make_batch_mesh` gives the serving path its one device; a request for
more raises until sharding is ported over ``torch.distributed``. The
training meshes (``make_production_mesh``, ``make_host_mesh``) come with the
model side (ROADMAP.md queue 1, "Sharding over several devices").
"""
from __future__ import annotations

from typing import Optional


def make_batch_mesh(n_devices: Optional[int] = None, device=None):
    """The serving mesh: one device (see
    :func:`repro_torch.parallel.batch.make_batch_mesh`)."""
    from repro_torch.parallel.batch import make_batch_mesh as _make

    return _make(n_devices, device)
