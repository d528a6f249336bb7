"""Sparse sky simulation (port of ``repro.sensing.sky``): point-source skies."""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def make_sky(resolution: int, n_sources: int, generator: torch.Generator,
             flux_range: tuple[float, float] = (0.5, 1.0), margin: int = 2,
             min_sep: int = 3, device=None) -> torch.Tensor:
    """An (r²,) real non-negative sky with ``n_sources`` point sources at
    least ``min_sep`` pixels apart: distinct cells of the min_sep-coarsened
    grid, jittered inside each cell. Drawn from ``generator`` on the CPU."""
    dev = resolve_device(device)
    cells = max(1, (resolution - 2 * margin) // max(1, min_sep))
    if n_sources > cells * cells:
        raise ValueError("too many sources for this resolution/min_sep")
    flat = torch.randperm(cells * cells, generator=generator)[:n_sources]
    ci, cj = flat // cells, flat % cells
    jit = torch.randint(0, max(1, min_sep - 1), (2, n_sources), generator=generator)
    ii = torch.clamp(ci * min_sep + margin + jit[0], 0, resolution - 1)
    jj = torch.clamp(cj * min_sep + margin + jit[1], 0, resolution - 1)
    lo, hi = flux_range
    flux = lo + (hi - lo) * torch.rand((n_sources,), generator=generator)
    img = torch.zeros((resolution, resolution), dtype=torch.float32)
    img[ii, jj] = flux
    return img.reshape(-1).to(dev)
