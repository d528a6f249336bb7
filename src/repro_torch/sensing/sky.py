"""Sparse sky simulation (port of ``repro.sensing.sky``): point-source skies
and helpers (paper §4: 30 strong sources on a 256×256 grid, recovered from
one LOFAR station).

Skies are the reference's, key for key: positions, jitter and fluxes come
from :mod:`repro_torch.random` under the same split of the key, so they equal
the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.device import resolve_device


def make_sky(resolution: int, n_sources: int, key: torch.Tensor,
             flux_range: tuple[float, float] = (0.5, 1.0), margin: int = 2,
             min_sep: int = 3, device=None) -> torch.Tensor:
    """An (r²,) real non-negative sky with ``n_sources`` point sources at
    least ``min_sep`` pixels apart: distinct cells of the min_sep-coarsened
    grid (``choice`` without replacement), jittered inside each cell.
    ``split(key, 3)`` gives the position, flux and jitter keys."""
    dev = resolve_device(device)
    kpos, kflux, kjit = prng.split(key, 3)
    cells = max(1, (resolution - 2 * margin) // max(1, min_sep))
    if n_sources > cells * cells:
        raise ValueError("too many sources for this resolution/min_sep")
    flat = prng.choice(kpos, cells * cells, n_sources).to(torch.int64)
    ci, cj = flat // cells, flat % cells
    jit = prng.randint(kjit, (2, n_sources), 0, max(1, min_sep - 1)).to(torch.int64)
    ii = torch.clamp(ci * min_sep + margin + jit[0], 0, resolution - 1)
    jj = torch.clamp(cj * min_sep + margin + jit[1], 0, resolution - 1)
    flux = prng.uniform(kflux, (n_sources,), minval=flux_range[0], maxval=flux_range[1])
    img = torch.zeros((resolution, resolution), dtype=torch.float32)
    img[ii, jj] = flux
    return img.reshape(-1).to(dev)


def to_image(x: torch.Tensor, resolution: int) -> torch.Tensor:
    """The (r, r) real image of a sky vector."""
    return (x.real if x.is_complex() else x).reshape(resolution, resolution)


def ascii_render(img, width: int = 64, levels: str = " .:-=+*#%@") -> str:
    """Terminal rendering of a sky image (numpy on the host)."""
    a = np.abs(img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img))
    r = a.shape[0]
    stride = max(1, r // width)
    a = a[::stride, ::stride]
    a = a / (a.max() + 1e-30)
    idx = (a * (len(levels) - 1)).astype(int)
    return "\n".join("".join(levels[v] for v in row) for row in idx)
