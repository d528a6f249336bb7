"""Model assembly (port of ``repro.models.model``), every family of the
reference: decoder LMs of "attn" blocks (GQA or MHA, RoPE, optional QKV
bias, RMSNorm or LayerNorm, SwiGLU, tanh-GELU or squared-ReLU MLP, or
Qwen3-MoE's mixture of SwiGLU experts, :mod:`.moe`), RecurrentGemma's
hybrid of "rec" blocks (the RG-LRU,
:mod:`.rglru`) and local-attention "attn" blocks (a sliding window of
``cfg.local_window`` keys, cached in a ring of that many slots), Mamba-2's
attention-free stack of "ssm" blocks (the SSD, :mod:`.ssm`; no MLP, a state
of fixed size), and the "xattn" blocks of Whisper's decoder and of
Llama-3.2-Vision's image layers: self-attention, then cross-attention over a
``memory`` (the output of :func:`encode` over audio frames, or image
embeddings), then the MLP. A serving cache's "xattn" entry holds the self
KV cache and the memory's K/V (``ck``, ``cv``), projected once in the
prefill and read by every decode step.

The parameter tree is the reference's: nested dicts of tensors, layers
stacked by period slot as ``(L, ...)`` under ``params["slots"]["slot<j>"]``
(keys sorted, as ``jax.vmap`` returns them), the remainder under
``params["tail"]``. Where the reference scans a slot, the port loops over its
layers: :func:`forward` splits each stacked leaf once (``torch.unbind``) and,
where autograd records and ``cfg.remat``, checkpoints each layer as the
reference's ``jax.checkpoint``; prefill and decode index each leaf (a
``QWeight`` too) at the layer.

Three execution paths share the block code:
  * :func:`forward` — teacher-forced logits over (B, S) tokens, and
    :func:`loss_fn`, the training loss over them,
  * :func:`prefill` — forward + KV cache construction (serving, long prompts),
  * :func:`decode_step` — one token against the cache (the bandwidth-bound
    loop the paper's technique speeds up with weight/KV quantization).

:func:`loss_fn` raises ``NotImplementedError`` for the encoder-decoder and
VLM families (their training is a later slice). The reference's SPMD hooks
(``constrain``, ``constrain_kv``) have no counterpart on one GPU.
:func:`init_quantized_params` builds a W<bits> tree leaf by leaf, so that a
model whose float32 tree does not fit the card (qwen3-moe-30b-a3b, ~122 GB)
is served from its ~16 GB of codes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import random as prng
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.layers import (
    KVCache,
    apply_norm,
    cache_kv,
    cache_update,
    cache_update_window,
    chunked_attention,
    decode_attention,
    dense,
    dense_init,
    init_kv_cache,
    mlp_apply,
    mlp_init,
    norm_init,
    rope,
    sinusoidal_at,
    sinusoidal_positions,
    window_valid_length,
)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.quantized import QWeight, materialize, quantize_params
from repro_torch.models.rglru import (
    RGLRUState,
    init_rglru_state,
    rglru_apply,
    rglru_decode_step,
    rglru_init,
    rglru_sequence,
)
from repro_torch.models.ssm import (
    SSMState,
    init_ssm_state,
    ssd_apply,
    ssd_decode_step,
    ssd_init,
    ssd_sequence,
)
from repro_torch.quant.policy import QuantPolicy
from repro_torch.tree import tree_leaves

_CROSS = ("encdec", "vlm")            # families whose "xattn" layers read a memory
_BLOCKS = ("attn", "xattn", "rec", "ssm")
_RECURRENT_STATES = (RGLRUState, SSMState)


# ---------------------------------------------------------------------------
# init


def _attn_init(key, cfg: ModelConfig, device=None):
    ks = prng.split(key, 4)
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.padded_heads, cfg.padded_kv_heads
    return {
        "wq": dense_init(ks[0], d, hq * hd, bias=cfg.qkv_bias, device=device),
        "wk": dense_init(ks[1], d, hkv * hd, bias=cfg.qkv_bias, device=device),
        "wv": dense_init(ks[2], d, hkv * hd, bias=cfg.qkv_bias, device=device),
        "wo": dense_init(ks[3], hq * hd, d, device=device),
    }


def _ffn_init(key, cfg: ModelConfig, device=None):
    if cfg.n_experts:
        return moe_init(key, cfg.d_model, cfg.d_ff, cfg.n_experts, device=device)
    return mlp_init(key, cfg.d_model, cfg.d_ff, cfg.mlp_type, device=device)


def _block_init(key, cfg: ModelConfig, kind: str, device=None):
    ks = prng.split(key, 6)
    d = cfg.d_model
    p: dict[str, Any] = {"ln1": norm_init(d, cfg.norm_type, device)}
    if kind in ("attn", "xattn"):
        p["attn"] = _attn_init(ks[0], cfg, device)
        if kind == "xattn":
            p["ln_x"] = norm_init(d, cfg.norm_type, device)
            p["xattn"] = _attn_init(ks[2], cfg, device)
    elif kind == "rec":
        p["rec"] = rglru_init(ks[0], d, cfg.rnn_width_, cfg.ssm_conv, device)
    elif kind == "ssm":
        p["ssm"] = ssd_init(ks[0], d, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv,
                            device)
        return p                                   # no ln2, no MLP
    else:
        raise ValueError(kind)
    p["ln2"] = norm_init(d, cfg.norm_type, device)
    p["ffn"] = _ffn_init(ks[1], cfg, device)
    return p


def _period_info(cfg: ModelConfig):
    pattern = cfg.pattern_for_layers()
    if cfg.family == "hybrid" and cfg.block_pattern:
        period = len(cfg.block_pattern)
    elif cfg.family == "vlm" and cfg.cross_attn_every:
        period = cfg.cross_attn_every
    else:
        period = 1
    n_full = cfg.n_layers // period
    slots = pattern[:period]
    tail = pattern[n_full * period:]
    return slots, n_full, tail


def _sorted_tree(tree):
    """The tree with every dict's keys in sorted order, as a ``jax.vmap``
    output has them (``quantize_params`` counts its keys in that order)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _stack_into(stacked, tree, i: int, n: int):
    """Write ``tree``'s leaves at index i of (n, ...) tensors, made at i = 0."""
    if isinstance(tree, dict):
        if stacked is None:
            stacked = {}
        for k, v in tree.items():
            stacked[k] = _stack_into(stacked.get(k), v, i, n)
        return stacked
    if isinstance(tree, QWeight):
        if stacked is None:
            stacked = QWeight(
                torch.empty((n,) + tuple(tree.packed.shape), dtype=tree.packed.dtype,
                            device=tree.packed.device),
                torch.empty((n,) + tuple(tree.scale.shape), dtype=tree.scale.dtype,
                            device=tree.scale.device), tree.bits, tree.k_dim)
        stacked.packed[i] = tree.packed
        stacked.scale[i] = tree.scale
        return stacked
    if stacked is None:
        stacked = torch.empty((n,) + tuple(tree.shape), dtype=tree.dtype, device=tree.device)
    stacked[i] = tree
    return stacked


def init_params(cfg: ModelConfig, key: torch.Tensor, device=None):
    """The reference's parameters for ``key``, float32, on ``device``
    (default ``cuda``): every draw is ``repro_torch.random``'s threefry, so
    the values are the reference's to within its erfinv rounding (~1e-6).
    A stacked slot is drawn layer by layer from ``split(fold_in(keys[2], j),
    n_full)``, as the reference's ``vmap`` draws it; an encoder's "attn"
    blocks (``params["encoder"]``) from ``split(keys[4], n_encoder_layers)``."""
    return _build_params(cfg, key, device, lambda tree: tree)


def init_quantized_params(cfg: ModelConfig, key: torch.Tensor, bits: int, device=None):
    """``quantize_params(init_params(cfg, key, device), bits)``, bit for bit,
    built leaf by leaf: each layer is drawn in float32 with init_params's
    keys, quantized and written into the stacked codes and scales before the
    next is drawn, and the unembedding is quantized as it is drawn. At no time
    does it hold more than one layer's float32 leaves beside the codes and
    the float32 token embedding (which stays dense). It rounds to nearest:
    stochastic rounding draws its uniforms in the order of the whole tree's
    kernels, so build that tree with init_params and quantize_params."""
    return _build_params(cfg, key, device, lambda tree: quantize_params(tree, bits))


def _build_params(cfg: ModelConfig, key: torch.Tensor, device, leaves):
    """init_params's tree with ``leaves`` applied to the unembedding and to
    each block as it is drawn, before it is stacked."""
    device = resolve_device(device)
    slots, n_full, tail = _period_info(cfg)
    keys = prng.split(key, 8)
    d, v = cfg.d_model, cfg.padded_vocab

    params: dict[str, Any] = {
        "embed": {"w": prng.normal(keys[0], (v, d), device=device) * 0.02},
        "final_norm": norm_init(d, cfg.norm_type, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = leaves({"w": prng.normal(keys[1], (v, d), device=device) * 0.02})

    def stack_init(base_key, kind, n):
        stacked = None
        for i, k in enumerate(prng.split(base_key, n)):
            stacked = _stack_into(stacked, leaves(_block_init(k, cfg, kind, device)), i, n)
        return _sorted_tree(stacked)

    params["slots"] = {
        f"slot{j}": stack_init(prng.fold_in(keys[2], j), kind, n_full)
        for j, kind in enumerate(slots)
    }
    params["tail"] = [
        leaves(_block_init(prng.fold_in(keys[3], i), cfg, kind, device))
        for i, kind in enumerate(tail)
    ]
    if cfg.n_encoder_layers:
        params["encoder"] = {
            "blocks": stack_init(keys[4], "attn", cfg.n_encoder_layers),
            "final_norm": norm_init(d, cfg.norm_type, device),
        }
    return params


# ---------------------------------------------------------------------------
# block application


@dataclasses.dataclass
class Ctx:
    cfg: ModelConfig
    positions: torch.Tensor                 # (B, S) integer positions
    policy: QuantPolicy
    memory: Optional[torch.Tensor] = None   # encoder output / image embeds (B, T, d)
    causal: bool = True
    window: Optional[int] = None


def _qkv(p, x, cfg, positions, n_heads):
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = dense(p["wq"], x).reshape(b, s, n_heads, hd)
    k = dense(p["wk"], x).reshape(b, s, cfg.padded_kv_heads, hd)
    v = dense(p["wv"], x).reshape(b, s, cfg.padded_kv_heads, hd)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # (B, H, S, D)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _self_attention(p, x, ctx: Ctx):
    """Full-sequence self-attention: with RoPE, except in the encdec family,
    whose positions are sinusoids added to the input (the reference's
    ``forward`` and ``encode``; its prefill and decode apply RoPE to both
    families, :func:`apply_block_prefill`)."""
    cfg = ctx.cfg
    q, k, v = _qkv(p, x, cfg, ctx.positions if cfg.family != "encdec" else None,
                   cfg.padded_heads)
    out = chunked_attention(q, k, v, causal=ctx.causal, chunk=cfg.attn_chunk,
                            window=ctx.window)
    b, h, s, hd = out.shape
    return dense(p["wo"], out.transpose(1, 2).reshape(b, s, h * hd))


def _memory_kv(p, cfg, memory: torch.Tensor):
    """The cross-attention's K and V (B, Hkv, T, D) of the memory (B, T, d),
    in the memory's dtype."""
    b, t, _ = memory.shape
    hkv, hd = cfg.padded_kv_heads, cfg.head_dim_
    k = dense(p["wk"], memory).reshape(b, t, hkv, hd).transpose(1, 2)
    v = dense(p["wv"], memory).reshape(b, t, hkv, hd).transpose(1, 2)
    return k, v


def _cross_attention(p, x, ctx: Ctx, kv=None):
    """Attention of the normed residual x (B, S, d) over every row of the
    memory, no mask; ``kv`` the memory's K/V if already projected
    (:func:`_memory_kv`). On the card, K/V of another dtype than q (the vlm's
    float32 image embeddings under a bf16 model) take ``chunked_attention``'s
    counted cast."""
    cfg = ctx.cfg
    b, s, _ = x.shape
    hq, hd = cfg.padded_heads, cfg.head_dim_
    q = dense(p["wq"], x).reshape(b, s, hq, hd).transpose(1, 2)
    k, v = _memory_kv(p, cfg, ctx.memory) if kv is None else kv
    out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return dense(p["wo"], out.transpose(1, 2).reshape(b, s, hq * hd))


def _ffn_apply(p, x, cfg: ModelConfig):
    """The block's FFN: (y, aux), aux the MoE load loss for the MoE family."""
    if cfg.n_experts:
        return moe_apply(p, x, top_k=cfg.experts_per_token,
                         capacity_factor=cfg.moe_capacity_factor, group_size=cfg.moe_group_size,
                         remat=cfg.remat)
    return mlp_apply(p, x, cfg.mlp_type), {}


def _require_block(kind: str) -> None:
    if kind not in _BLOCKS:
        raise ValueError(kind)


def apply_block_fwd(kind: str, p, x, ctx: Ctx):
    """Full-sequence forward (the decoder's layers and the encoder's).
    Returns (x, aux)."""
    _require_block(kind)
    cfg = ctx.cfg
    h = apply_norm(p["ln1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "ssm":
        return x + ssd_apply(p["ssm"], h, cfg), {}
    if kind in ("attn", "xattn"):
        x = x + _self_attention(p["attn"], h, ctx)
        if kind == "xattn":
            hx = apply_norm(p["ln_x"], x, cfg.norm_type, cfg.norm_eps)
            x = x + _cross_attention(p["xattn"], hx, ctx)
    else:
        x = x + rglru_apply(p["rec"], h, cfg.rnn_width_)
    h2 = apply_norm(p["ln2"], x, cfg.norm_type, cfg.norm_eps)
    y, aux = _ffn_apply(p["ffn"], h2, cfg)
    return x + y, aux


def _empty_cache_entry(kind: str, cfg: ModelConfig, b: int, cache_len: int, dtype,
                       kv_bits, device, mem_len: int = 0):
    if kind == "rec":
        return init_rglru_state(b, cfg.rnn_width_, cfg.ssm_conv, device)
    if kind == "ssm":
        return init_ssm_state(b, cfg, device)
    _require_block(kind)
    hkv, hd = cfg.padded_kv_heads, cfg.head_dim_
    if kind == "xattn":
        return {"self": init_kv_cache(b, hkv, cache_len, hd, dtype, kv_bits, device),
                "ck": torch.zeros((b, hkv, mem_len, hd), dtype=dtype, device=device),
                "cv": torch.zeros((b, hkv, mem_len, hd), dtype=dtype, device=device)}
    if cfg.family == "hybrid" and cfg.local_window:
        cache_len = min(cache_len, cfg.local_window)
    return init_kv_cache(b, hkv, cache_len, hd, dtype, kv_bits, device)


def _rec_ffn(p, x, y, cfg):
    """The rest of a "rec" block after the RG-LRU's output y."""
    x = x + y
    h2 = apply_norm(p["ln2"], x, cfg.norm_type, cfg.norm_eps)
    yf, _ = _ffn_apply(p["ffn"], h2, cfg)
    return x + yf


def _rglru_prefill(p, u, cfg, state: RGLRUState):
    """The RG-LRU over the prompt from the state's conv (h from 0, as the
    reference's ``_rglru_prefill``), and the state after its last token."""
    y, conv_new, h_last = rglru_sequence(p, u, state.conv)
    return y, RGLRUState(conv=conv_new, h=h_last)


def _ssd_prefill(p, u, cfg, state: SSMState):
    """The SSD over the prompt u (B, S, d), projected and run once: y, and the
    state after its last token (the chunk loop's final state; the conv state
    the last d_conv − 1 pre-conv inputs, float32, as the reference's
    ``_ssd_prefill`` leaves them). Where the reference's prefill fails, this
    raises: S not a multiple of min(chunk, S) (its ``_ssd_final_state`` does
    not pad, and padding here would move the state, softplus(dt_bias) ≠ 0),
    and S < d_conv − 1 (its conv state comes out short, and the next decode
    step fails)."""
    s, k = u.shape[1], cfg.ssm_conv
    ck = min(cfg.ssm_chunk, s)
    if s % ck:
        raise ValueError(f"prefill ({cfg.name}): a prompt of {s} tokens is not a multiple of "
                         f"min(ssm_chunk, S) = {ck}; the reference's _ssd_final_state cannot "
                         f"reshape it either")
    if s < k - 1:
        raise ValueError(f"prefill ({cfg.name}): a prompt of {s} tokens is shorter than "
                         f"d_conv - 1 = {k - 1}; the reference builds a conv state of {s} rows "
                         f"and its next decode step fails")
    y, xbc_in, final = ssd_sequence(p, u, cfg)
    conv = xbc_in[:, -(k - 1):, :].to(torch.float32) if k > 1 else state.conv
    return y, SSMState(conv=conv, ssm=final)


def _write_memory_kv(entry, k, v, cfg) -> None:
    """The memory's K/V into an "xattn" entry's ck and cv, in place, in the
    cache's dtype (the activations', as the reference stores them)."""
    if tuple(entry["ck"].shape) != tuple(k.shape):
        raise ValueError(f"the cross-attention cache holds memory of shape "
                         f"{tuple(entry['ck'].shape)}, the memory gives {tuple(k.shape)}: size "
                         f"it with init_cache(..., mem_len={k.shape[2]}) ({cfg.name})")
    entry["ck"].copy_(k)
    entry["cv"].copy_(v)


def apply_block_prefill(kind: str, p, x, cache_entry, ctx: Ctx):
    """Forward + cache fill. Returns (x, cache_entry): a KVCache for
    "attn"; for "xattn" a dict of the self KVCache and the memory's K/V
    ``ck``, ``cv`` (written in place; projected once and used for both the
    attention and the cache, the reference projects twice); the RGLRUState
    or SSMState after the prompt for "rec" or "ssm". Self-attention applies
    RoPE in both cross-attention families, as the reference's prefill does
    (its ``forward`` drops it for encdec)."""
    _require_block(kind)
    cfg = ctx.cfg
    h = apply_norm(p["ln1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "ssm":
        y, new_state = _ssd_prefill(p["ssm"], h, cfg, cache_entry)
        return x + y, new_state
    if kind == "rec":
        y, new_state = _rglru_prefill(p["rec"], h, cfg, cache_entry)
        return _rec_ffn(p, x, y, cfg), new_state
    q, k, v = _qkv(p["attn"], h, cfg, ctx.positions, cfg.padded_heads)
    out = chunked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk, window=ctx.window)
    b, hh, s, hd = out.shape
    x = x + dense(p["attn"]["wo"], out.transpose(1, 2).reshape(b, s, hh * hd))
    if kind == "xattn":
        hx = apply_norm(p["ln_x"], x, cfg.norm_type, cfg.norm_eps)
        mk, mv = _memory_kv(p["xattn"], cfg, ctx.memory)
        x = x + _cross_attention(p["xattn"], hx, ctx, (mk, mv))
        _write_memory_kv(cache_entry, mk, mv, cfg)
        cache_entry = {"self": cache_update(cache_entry["self"], k, v, ctx.policy.kv_bits),
                       "ck": cache_entry["ck"], "cv": cache_entry["cv"]}
    elif ctx.window is not None:
        cache_entry = cache_update_window(cache_entry, k, v, ctx.window, ctx.policy.kv_bits)
    else:
        cache_entry = cache_update(cache_entry, k, v, ctx.policy.kv_bits)
    h2 = apply_norm(p["ln2"], x, cfg.norm_type, cfg.norm_eps)
    y, _ = _ffn_apply(p["ffn"], h2, cfg)
    return x + y, cache_entry


def apply_block_decode(kind: str, p, x, cache_entry, ctx: Ctx):
    """One-token step against the cache. x: (B, 1, d)."""
    _require_block(kind)
    cfg = ctx.cfg
    h = apply_norm(p["ln1"], x, cfg.norm_type, cfg.norm_eps)
    if kind == "ssm":
        y, new_state = ssd_decode_step(p["ssm"], h, cache_entry, cfg)
        return x + y, new_state
    if kind == "rec":
        y, new_state = rglru_decode_step(p["rec"], h, cache_entry, cfg.rnn_width_)
        return _rec_ffn(p, x, y, cfg), new_state
    q, k_new, v_new = _qkv(p["attn"], h, cfg, ctx.positions, cfg.padded_heads)
    entry = cache_entry["self"] if kind == "xattn" else cache_entry
    if ctx.window is not None:
        entry = cache_update_window(entry, k_new, v_new, ctx.window, ctx.policy.kv_bits)
        length = window_valid_length(entry, ctx.window)
    else:
        entry = cache_update(entry, k_new, v_new, ctx.policy.kv_bits)
        length = entry.length
    k_all, v_all = cache_kv(entry, ctx.policy.kv_bits, x.dtype)
    out = decode_attention(q, k_all, v_all, length=length)
    b, hh, _, hd = out.shape
    x = x + dense(p["attn"]["wo"], out.transpose(1, 2).reshape(b, 1, hh * hd))
    if kind == "xattn":
        hx = apply_norm(p["ln_x"], x, cfg.norm_type, cfg.norm_eps)
        qx = dense(p["xattn"]["wq"], hx).reshape(b, 1, hh, hd).transpose(1, 2)
        ck, cv = cache_entry["ck"], cache_entry["cv"]
        ox = decode_attention(qx, ck, cv, length=ck.shape[2])
        x = x + dense(p["xattn"]["wo"], ox.transpose(1, 2).reshape(b, 1, hh * hd))
        entry = {"self": entry, "ck": ck, "cv": cv}
    h2 = apply_norm(p["ln2"], x, cfg.norm_type, cfg.norm_eps)
    y, _ = _ffn_apply(p["ffn"], h2, cfg)
    return x + y, entry


# ---------------------------------------------------------------------------
# whole-model paths


def _at_layer(tree, i: int):
    """Layer i of a stacked slot: every tensor and QWeight indexed at i."""
    if isinstance(tree, dict):
        return {k: _at_layer(v, i) for k, v in tree.items()}
    if isinstance(tree, KVCache):
        return KVCache(*(None if a is None else a[i] for a in tree[:4]), length=tree.length)
    if isinstance(tree, _RECURRENT_STATES):
        return type(tree)(*(a[i] for a in tree))
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The n layers of a stacked slot, each leaf split once with
    ``torch.unbind`` (a QWeight's codes and scales too). Indexing a leaf per
    layer would make autograd build a full-size zero gradient of the stacked
    leaf for every layer; unbind's backward stacks the layers' gradients
    once."""
    if isinstance(tree, dict):
        per_key = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, QWeight):
        return [QWeight(p, s, tree.bits, tree.k_dim)
                for p, s in zip(tree.packed.unbind(0), tree.scale.unbind(0))]
    return list(tree.unbind(0))


def _block_x(kind, p, x, ctx):
    x, aux = apply_block_fwd(kind, p, x, ctx)
    return x, aux.get("moe_load_loss")


def _run_forward(cfg, params, x, ctx):
    """Every layer's full-sequence forward in order (slots period by period,
    then the tail), and the sum of the layers' MoE load losses (float32, 0
    without experts). Where autograd records and ``cfg.remat``, each layer is
    checkpointed (``torch.utils.checkpoint``, non-reentrant), as the
    reference wraps its period body in ``jax.checkpoint``: only the layer
    inputs stay alive, and the backward runs each layer's forward again."""
    slots, n_full, tail = _period_info(cfg)
    layers = {f"slot{j}": _unstack(params["slots"][f"slot{j}"], n_full)
              for j in range(len(slots))}

    def recorded(p, x) -> bool:
        return torch.is_grad_enabled() and (x.requires_grad or any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(p)))

    def block(kind, p, x):
        if cfg.remat and recorded(p, x):
            return torch.utils.checkpoint.checkpoint(_block_x, kind, p, x, ctx,
                                                     use_reentrant=False,
                                                     preserve_rng_state=False)
        return _block_x(kind, p, x, ctx)

    load = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in ([(kind, layers[f"slot{j}"][i]) for i in range(n_full)
                     for j, kind in enumerate(slots)]
                    + [(kind, params["tail"][i]) for i, kind in enumerate(tail)]):
        x, aux = block(kind, p, x)
        if aux is not None:
            load = load + aux
    return x, load


def _write_state(stacked, i: int, new):
    """Layer i's new recurrent state (an RGLRUState or SSMState) into the
    stacked slot, in place. Each field keeps the dtype the reference's step
    leaves it in (the RG-LRU's conv state the activations' dtype; the SSD's
    float32 after a prefill and the activations' dtype after a decode step):
    a stacked field of another dtype is replaced once by one of that dtype,
    which the same pass over the layers fills."""
    fields = []
    for old, val in zip(stacked, new):
        if old.dtype != val.dtype:
            old = torch.empty(old.shape, dtype=val.dtype, device=old.device)
        old[i] = val
        fields.append(old)
    return type(stacked)(*fields)


def _run_stack(cfg, params, x, cache, block, ctx):
    """Every layer in order with its cache entry (prefill, decode). A slot's
    KV caches (and an "xattn" slot's ck and cv) are written in place and its
    host length updated; a slot's recurrent states are written into it layer
    by layer (:func:`_write_state`). Returns (x, new cache)."""
    slots, n_full, tail = _period_info(cfg)
    new_slots = dict(cache["slots"])
    for i in range(n_full):
        for j, kind in enumerate(slots):
            name = f"slot{j}"
            x, entry = block(kind, _at_layer(params["slots"][name], i), x,
                             _at_layer(cache["slots"][name], i), ctx)
            if isinstance(entry, _RECURRENT_STATES):
                new_slots[name] = _write_state(new_slots[name], i, entry)
            elif isinstance(entry, dict):
                slot = new_slots[name]
                new_slots[name] = {**slot,
                                   "self": slot["self"]._replace(length=entry["self"].length)}
            else:
                new_slots[name] = new_slots[name]._replace(length=entry.length)
    new_cache = {"slots": new_slots, "tail": []}
    for i, kind in enumerate(tail):
        x, c = block(kind, params["tail"][i], x, cache["tail"][i], ctx)
        new_cache["tail"].append(c)
    return x, new_cache


def _embed(cfg, params, tokens, dtype):
    # F.embedding: on the card its backward sums a repeated token's rows in a
    # fixed order (PyTorch's indexing backward does not by default), which
    # keeps a resumed training run bit for bit
    return F.embedding(tokens, params["embed"]["w"]).to(dtype)


def _unembed(cfg, params, x):
    w = params["embed"]["w"] if cfg.tie_embeddings else params["unembed"]["w"]
    wt = materialize(w, x.dtype)
    if wt.shape[0] == cfg.padded_vocab:          # stored (V, d)
        return x @ wt.T
    return x @ wt


def _window(cfg) -> Optional[int]:
    """The local attention window: the hybrid family's, else none."""
    return cfg.local_window if cfg.family == "hybrid" else None


def _positions(b: int, s: int, start: int, device) -> torch.Tensor:
    return torch.arange(start, start + s, dtype=torch.int32, device=device).expand(b, s)


def _require_memory(cfg: ModelConfig, what: str, memory) -> None:
    """The cross-attention families' layers read a memory: raise without one
    (the reference fails deep inside ``dense`` there)."""
    if cfg.family in _CROSS and memory is None:
        raise ValueError(
            f"{what}: the {cfg.family} family ({cfg.name}) reads a memory in its 'xattn' "
            f"layers; pass memory= ("
            + ("the output of encode(cfg, params, frames)" if cfg.family == "encdec" else
               "the image embeddings, (B, n_image_tokens, d_model)") + ")")


def _embed_positions(cfg, x: torch.Tensor, position: Optional[int] = None) -> torch.Tensor:
    """The encdec family's sinusoidal positions added to its token
    embeddings x (B, S, d): 0 ... S − 1, or the one ``position`` of a decode
    step; other families' x unchanged."""
    if cfg.family != "encdec":
        return x
    if position is None:
        pos = sinusoidal_positions(x.shape[1], cfg.d_model, x.device)[None]
    else:
        pos = sinusoidal_at(position, cfg.d_model, x.device)[None, None]
    return x + pos.to(x.dtype)


def encode(cfg: ModelConfig, params, frames: torch.Tensor,
           policy: QuantPolicy = QuantPolicy()) -> torch.Tensor:
    """Whisper-style encoder over stub frame embeddings (B, T, d): the frames
    in the config's dtype plus sinusoidal positions, ``n_encoder_layers``
    non-causal "attn" blocks without RoPE, the final norm. The memory that
    the encdec family's ``forward`` and ``prefill`` take."""
    if not cfg.n_encoder_layers:
        raise ValueError(f"encode: {cfg.name} has no encoder (n_encoder_layers = 0)")
    dtype = torch_dtype(cfg.dtype)
    x = frames.to(dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(dtype)[None]
    ctx = Ctx(cfg=cfg, positions=None, policy=policy, causal=False)
    for p in _unstack(params["encoder"]["blocks"], cfg.n_encoder_layers):
        x, _ = apply_block_fwd("attn", p, x, ctx)
    enc = params["encoder"]["final_norm"]
    return apply_norm(enc, x, cfg.norm_type, cfg.norm_eps)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            policy: QuantPolicy = QuantPolicy(), memory: Optional[torch.Tensor] = None):
    """Teacher-forced logits (B, S, V) in the config's dtype, and the aux dict
    (``moe_load_loss``: the layers' load losses summed, 0 without experts).
    The hybrid family's attention is local, a window of ``cfg.local_window``
    keys, as in prefill and decode. ``memory`` (B, T, d), required by the encdec and vlm
    families: the output of :func:`encode`, or image embeddings."""
    _require_memory(cfg, "forward", memory)
    b, s = tokens.shape
    x = _embed_positions(cfg, _embed(cfg, params, tokens, torch_dtype(cfg.dtype)))
    ctx = Ctx(cfg=cfg, positions=_positions(b, s, 0, tokens.device), policy=policy,
              memory=memory, causal=True, window=_window(cfg))
    x, load = _run_forward(cfg, params, x, ctx)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    return _unembed(cfg, params, x), {"moe_load_loss": load}


def loss_fn(cfg: ModelConfig, params, batch, policy: QuantPolicy = QuantPolicy()):
    """Mean next-token cross entropy over a float32 log-softmax; labels < 0
    are padding. batch: ``tokens`` and ``labels`` (B, S). Differentiable in
    the parameters: call it with leaves that require a gradient. The dense,
    MoE (with the load term 0.01·moe_load_loss/n_layers), hybrid and SSM
    families train; the encdec and vlm families raise: their training is a
    later slice."""
    if cfg.family in _CROSS:
        raise NotImplementedError(
            f"loss_fn: the {cfg.family} family ({cfg.name}) serves but does not train yet: "
            f"ROADMAP.md §1 queues the cross-attention families' training next")
    logits, aux = forward(cfg, params, batch["tokens"], policy=policy)
    labels = batch["labels"]
    mask = labels >= 0
    labels_safe = torch.clamp_min(labels, 0).to(torch.int64)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1)
    if cfg.n_experts:
        loss = loss + 0.01 * aux["moe_load_loss"] / max(cfg.n_layers, 1)
    return loss


def init_cache(cfg: ModelConfig, b: int, cache_len: int, policy: QuantPolicy = QuantPolicy(),
               mem_len: int = 0, device=None):
    """Stacked cache matching the slot structure, on ``device`` (default
    ``cuda``): each attention slot's KVCache holds (n_full, B, Hkv, S, D)
    tensors and one host length (S at most ``cfg.local_window`` for the
    hybrid family); each "xattn" slot a dict of that KVCache (``"self"``)
    and the memory's K/V, ``"ck"`` and ``"cv"`` (n_full, B, Hkv, mem_len, D)
    in the config's dtype; each recurrent slot's RGLRUState (n_full, B,
    d_conv − 1, W) conv and (n_full, B, W) h, float32 until a prefill, or
    SSMState (n_full, B, d_conv − 1, conv_dim) conv and (n_full, B, H, hd,
    ds) ssm, float32."""
    device = resolve_device(device)
    slots, n_full, tail = _period_info(cfg)
    dtype = torch_dtype(cfg.dtype)

    def stack(a):
        return None if a is None else a.expand((n_full,) + a.shape).clone()

    def stacked(kind):
        one = _empty_cache_entry(kind, cfg, b, cache_len, dtype, policy.kv_bits, device, mem_len)
        if isinstance(one, _RECURRENT_STATES):
            return type(one)(*(stack(a) for a in one))
        if kind != "xattn":
            return KVCache(*(stack(a) for a in one[:4]), length=0)
        return {"self": KVCache(*(stack(a) for a in one["self"][:4]), length=0),
                "ck": stack(one["ck"]), "cv": stack(one["cv"])}

    return {
        "slots": {f"slot{j}": stacked(kind) for j, kind in enumerate(slots)},
        "tail": [_empty_cache_entry(kind, cfg, b, cache_len, dtype, policy.kv_bits, device,
                                    mem_len) for kind in tail],
    }


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, cache, *,
            policy: QuantPolicy = QuantPolicy(), memory=None):
    """Run the prompt, fill the cache (in place). Returns (last-position
    logits (B, V), cache). ``memory`` (B, T, d), required by the encdec and
    vlm families, must match the cache's ``mem_len``."""
    _require_memory(cfg, "prefill", memory)
    b, s = tokens.shape
    x = _embed_positions(cfg, _embed(cfg, params, tokens, torch_dtype(cfg.dtype)))
    ctx = Ctx(cfg=cfg, positions=_positions(b, s, 0, tokens.device), policy=policy,
              memory=memory, causal=True, window=_window(cfg))
    x, new_cache = _run_stack(cfg, params, x, cache, apply_block_prefill, ctx)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = _unembed(cfg, params, x[:, -1:, :])
    return logits[:, 0], new_cache


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache, *,
                policy: QuantPolicy = QuantPolicy(), position=None):
    """One serving step. token: (B,) integer → logits (B, V), updated cache
    (in place). ``position`` defaults to the cache's length. The "xattn"
    layers read the memory's K/V that the prefill cached."""
    b = token.shape[0]
    position = _cache_length(cfg, cache) if position is None else int(position)
    x = _embed_positions(cfg, _embed(cfg, params, token[:, None], torch_dtype(cfg.dtype)),
                         position)
    ctx = Ctx(cfg=cfg, positions=_positions(b, 1, position, token.device), policy=policy,
              causal=True, window=_window(cfg))
    x, new_cache = _run_stack(cfg, params, x, cache, apply_block_decode, ctx)
    x = apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
    logits = _unembed(cfg, params, x)
    return logits[:, 0], new_cache


def _cache_length(cfg, cache) -> int:
    """Current length from the first attention cache (a host integer; an
    "xattn" entry's self cache); a recurrent slot holds none, and an
    attention-free stack has length 0, as the reference's (no layer of it
    reads a position)."""
    for v in cache["slots"].values():
        if isinstance(v, KVCache):
            return v.length
        if isinstance(v, dict) and "self" in v:
            return v["self"].length
    return 0
