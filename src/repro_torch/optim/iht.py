"""IHT as a training feature (port of ``repro.optim.iht``): projected-gradient
sparsity through the paper's H_s. After each optimizer update, every large
weight leaf is hard-thresholded to its ``keep`` largest magnitudes,
``w ← H_s(w − η∇L)`` (iterative magnitude pruning as projected descent).

The threshold is the streaming histogram H_s with ``hsthresh_ref``'s
semantics (nbins 4,096, threshold-bin ties filled by index, so a tied
plateau keeps ``keep`` entries instead of none). On the card each eligible
leaf, flattened, is one row of the fused ``repro_hsthresh`` kernel; on the
CPU it is the plain version. The kept support is written into the leaf in
place: ``w`` where H_s(w) ≠ 0, else 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.hsthresh.ops import hsthresh
from repro_torch.tree import last_key, tree_flatten_with_path

NBINS = 4096
_NAMES = ("w", "wi_gate", "wi_up", "wo")


class IHTConfig(NamedTuple):
    sparsity: float = 0.5          # fraction of entries to zero per matrix
    min_size: int = 4096           # only project matrices at least this big
    every: int = 1                 # project every k optimizer steps


def _named(path) -> bool:
    return last_key(path) in _NAMES


def eligible(path, leaf, cfg: IHTConfig) -> bool:
    """The reference's predicate: the last path key (a dict key) one of
    ``w``/``wi_gate``/``wi_up``/``wo``, ndim ≥ 2, size ≥ ``min_size``,
    float32 or bfloat16."""
    return (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 and leaf.numel() >= cfg.min_size
            and _named(path) and leaf.dtype in (torch.float32, torch.bfloat16))


def keep_count(leaf: torch.Tensor, cfg: IHTConfig) -> int:
    return max(1, int(leaf.numel() * (1.0 - cfg.sparsity)))


def project_matrix_(w: torch.Tensor, keep: int, nbins: int = NBINS) -> torch.Tensor:
    """H_s of ``w`` flattened, written into ``w``: entries outside the kept
    support become 0."""
    flat = hsthresh(w.view(1, -1).to(torch.float32), keep, nbins=nbins)
    return w.masked_fill_(flat.view(w.shape) == 0, 0)


def project_params(params, cfg: IHTConfig):
    """H_s on every eligible leaf of ``params``, in place; returns ``params``."""
    with torch.no_grad():
        for path, leaf in tree_flatten_with_path(params):
            if eligible(path, leaf, cfg):
                project_matrix_(leaf, keep_count(leaf, cfg))
    return params


def maybe_project(params, step: int, cfg: IHTConfig):
    """Project when ``step`` is a multiple of ``cfg.every``."""
    if int(step) % cfg.every == 0:
        return project_params(params, cfg)
    return params


def sparsity_report(params, cfg: IHTConfig) -> float:
    """Measured zero fraction of the eligible matrices (the reference does
    not test the dtype here)."""
    total = zeros = 0
    for path, leaf in tree_flatten_with_path(params):
        if (isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 and leaf.numel() >= cfg.min_size
                and _named(path)):
            total += leaf.numel()
            zeros += leaf.numel() - int(torch.count_nonzero(leaf))
    return zeros / max(total, 1)
