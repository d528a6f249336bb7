"""Carry the reference's state across: the JAX package's arrays, handed over
as numpy (or anything ``np.asarray`` accepts), become the port's objects.

* :func:`key_from_numpy` — a uint32[2] PRNG key → a :mod:`repro_torch.random` key;
* :func:`packed_weights_from_numpy` / :func:`packed_operator_from_numpy` —
  packed bytes, scale, bits, k_dim and granularity → ``PackedWeights`` /
  ``PackedOperator``;
* :func:`problem_from_numpy` — a CS problem's Φ, y, x_true, e and s → ``CSProblem``;
* :func:`lm_params_from_numpy` — an LM parameter tree (nested dicts and lists
  of arrays; a quantized kernel as its ``packed``/``scale`` arrays with
  ``bits``/``k_dim``) → the same tree of tensors and ``QWeight``s;
* :func:`lm_cache_from_numpy` — an LM serving cache (stacked slots and the
  tail; ``k``/``v``/``k_scale``/``v_scale``/``length`` KV caches,
  ``conv``/``h`` and ``conv``/``ssm`` recurrent states, and cross-attention
  entries ``{"self", "ck", "cv"}``) → the same tree of ``KVCache``s,
  ``RGLRUState``s, ``SSMState``s and tensors;
* :func:`train_state_from_numpy` — a training state (params, AdamW's
  ``mu``/``nu``, the step counts and the key) → ``TrainState``.

The tests use these so that both packages compute on identical inputs. Any
object with the reference's attribute names (``packed``, ``scale``,
``bits``, ``k_dim``; ``fwd_re`` ...; ``phi``, ``y`` ...; ``k``, ``length``;
``conv``, ``h``) is accepted; nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.qmm.ops import PackedOperator, PackedWeights
from repro_torch.models.layers import KVCache
from repro_torch.models.quantized import QWeight
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.ssm import SSMState
from repro_torch.optim.adamw import AdamWState
from repro_torch.quant.formats import as_granularity
from repro_torch.sensing.gaussian import CSProblem
from repro_torch.train.state import TrainState


def key_from_numpy(key) -> torch.Tensor:
    words = np.asarray(key)
    if words.shape != (2,) or words.dtype != np.uint32:
        raise ValueError(f"expected a uint32[2] key, got {words.dtype}{list(words.shape)}")
    return torch.from_numpy(words.astype(np.int64))


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """np.asarray(a) as a tensor on ``device`` (dtype kept; numpy's bfloat16
    extension type, as JAX hands bfloat16 arrays over, becomes
    torch.bfloat16 of the same bits)."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


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


def lm_params_from_numpy(params, device=None):
    """The reference's LM parameter tree as the port's: dicts and lists keep
    their keys and order, arrays become tensors on ``device``, and an object
    with ``packed``, ``scale``, ``bits`` and ``k_dim`` (a quantized kernel)
    becomes a :class:`~repro_torch.models.quantized.QWeight` of the same
    bytes."""
    if isinstance(params, dict):
        return {k: lm_params_from_numpy(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(lm_params_from_numpy(v, device) for v in params)
    if all(hasattr(params, a) for a in ("packed", "scale", "bits", "k_dim")):
        return QWeight(tensor_from_numpy(params.packed, device),
                       tensor_from_numpy(np.asarray(params.scale, np.float32), device),
                       int(params.bits), int(params.k_dim))
    return tensor_from_numpy(params, device)


def lm_cache_from_numpy(cache, device=None):
    """The reference's LM serving cache as the port's: dicts and lists keep
    their keys and order; an object with ``k``, ``v``, ``k_scale``,
    ``v_scale`` and ``length`` becomes a
    :class:`~repro_torch.models.layers.KVCache` on ``device`` whose length is
    a host integer (a stacked slot's lengths are one per layer and equal: the
    first is taken); one with ``conv`` and ``h`` becomes a
    :class:`~repro_torch.models.rglru.RGLRUState`, one with ``conv`` and
    ``ssm`` a :class:`~repro_torch.models.ssm.SSMState`, and an array (a
    cross-attention entry's ``ck`` and ``cv``) a tensor, dtypes kept."""
    if isinstance(cache, dict):
        return {k: lm_cache_from_numpy(v, device) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)) and not hasattr(cache, "_fields"):
        return type(cache)(lm_cache_from_numpy(v, device) for v in cache)
    if all(hasattr(cache, a) for a in ("k", "v", "k_scale", "v_scale", "length")):
        lengths = np.asarray(cache.length).reshape(-1)
        if lengths.size and (lengths != lengths[0]).any():
            raise ValueError(f"a stacked KV cache's layers hold different lengths {lengths}")

        def conv(a):
            return None if a is None else tensor_from_numpy(a, device)
        return KVCache(conv(cache.k), conv(cache.v), conv(cache.k_scale), conv(cache.v_scale),
                       length=int(lengths[0]))
    if hasattr(cache, "conv") and hasattr(cache, "h"):
        return RGLRUState(tensor_from_numpy(cache.conv, device), tensor_from_numpy(cache.h, device))
    if hasattr(cache, "conv") and hasattr(cache, "ssm"):
        return SSMState(tensor_from_numpy(cache.conv, device), tensor_from_numpy(cache.ssm, device))
    if isinstance(cache, np.ndarray):
        return tensor_from_numpy(cache, device)
    raise TypeError(f"not a cache entry: {type(cache).__name__}")


def train_state_from_numpy(state, device=None):
    """The reference's ``TrainState`` (``step``, ``params``, ``opt`` with
    ``step``/``mu``/``nu``, ``rng``), handed over as numpy or anything
    ``np.asarray`` takes, as the port's: the parameter and moment trees on
    ``device``, the step counts as host int32 tensors, the key as a
    :mod:`repro_torch.random` key."""
    def count(x) -> torch.Tensor:
        return torch.tensor(int(np.asarray(x)), dtype=torch.int32)

    opt = AdamWState(step=count(state.opt.step),
                     mu=lm_params_from_numpy(state.opt.mu, device),
                     nu=lm_params_from_numpy(state.opt.nu, device))
    return TrainState(step=count(state.step), params=lm_params_from_numpy(state.params, device),
                      opt=opt, rng=key_from_numpy(state.rng))
