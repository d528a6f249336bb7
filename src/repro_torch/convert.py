"""Carry the reference's state across: the JAX package's arrays, handed over
as numpy (or anything ``np.asarray`` accepts), become the port's objects.

* :func:`key_from_numpy` — a uint32[2] PRNG key → a :mod:`repro_torch.random` key;
* :func:`packed_weights_from_numpy` / :func:`packed_operator_from_numpy` —
  packed bytes, scale, bits, k_dim and granularity → ``PackedWeights`` /
  ``PackedOperator``;
* :func:`problem_from_numpy` — a CS problem's Φ, y, x_true, e and s → ``CSProblem``.

The tests use these so that both packages compute on identical inputs. Any
object with the reference's attribute names (``packed``, ``scale``,
``bits``, ``k_dim``; ``fwd_re`` ...; ``phi``, ``y`` ...) is accepted; nothing
here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.qmm.ops import PackedOperator, PackedWeights
from repro_torch.quant.formats import as_granularity
from repro_torch.sensing.gaussian import CSProblem


def key_from_numpy(key) -> torch.Tensor:
    words = np.asarray(key)
    if words.shape != (2,) or words.dtype != np.uint32:
        raise ValueError(f"expected a uint32[2] key, got {words.dtype}{list(words.shape)}")
    return torch.from_numpy(words.astype(np.int64))


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """np.asarray(a) as a tensor on ``device`` (dtype kept)."""
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def packed_weights_from_numpy(w, device=None) -> PackedWeights:
    packed = np.asarray(w.packed)
    if packed.dtype != np.uint8:
        raise ValueError(f"packed codes must be uint8, got {packed.dtype}")
    gran = as_granularity(str(getattr(w, "granularity", "per_tensor")))
    scale = np.asarray(w.scale, np.float32)
    return PackedWeights(
        packed=tensor_from_numpy(packed, device),
        # (N, ⌈K/g⌉) for per_block, else one scale per row as (1, N)
        scale=tensor_from_numpy(scale if gran.kind == "per_block" else scale.reshape(1, -1),
                                device),
        bits=int(w.bits),
        k_dim=int(w.k_dim),
        granularity=gran,
    )


def packed_operator_from_numpy(op, device=None) -> PackedOperator:
    def conv(w):
        return None if w is None else packed_weights_from_numpy(w, device)

    return PackedOperator(fwd_re=conv(op.fwd_re), fwd_im=conv(op.fwd_im),
                          adj_re=conv(op.adj_re), adj_im=conv(op.adj_im))


def problem_from_numpy(prob, device=None) -> CSProblem:
    return CSProblem(phi=tensor_from_numpy(prob.phi, device),
                     y=tensor_from_numpy(prob.y, device),
                     x_true=tensor_from_numpy(prob.x_true, device),
                     e=tensor_from_numpy(prob.e, device),
                     s=int(prob.s))
