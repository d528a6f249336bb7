"""repro_torch.models' cross-attention families against repro.models on the
CPU: whisper-tiny (encdec: ``encode`` over stub frames, a decoder of "xattn"
blocks, sinusoidal positions) and llama-3.2-vision-11b (vlm: an "xattn"
image layer in each period of five, over stub image embeddings).

The SMOKE configs (whisper-tiny-smoke: 2 encoder and 2 decoder layers,
d = 64, 4 heads of 16, 64 frames; llama-3.2-vision-11b-smoke: 5 layers, one
period (attn, attn, attn, xattn, attn), 4/2 heads of 16, 16 image rows),
B = 2, a prompt of 16 tokens and two decode steps; and the vlm cut to
``cross_attn_every = 2`` (five layers (xattn, attn) × 2 + xattn), so that an
"xattn" layer sits in a stacked slot of two and in the tail.

Tolerances, as tests/test_torch_lm_model.py states them: initial weights
within 1e-6 (the port's threefry normals differ from JAX's only in the order
of the erfinv polynomial's float operations); ``encode``, the logits and the
cached cross K/V of the float32 variant within 1e-5·max|reference|, full
precision and W4KV8 (the codes carried across, so both compute on the same
bytes); the bfloat16 SMOKE configs under W4KV8 within 2e-2·max|logits|.
Quantized codes and scales bit for bit. Each reference function is compiled
once per case: one jit runs encode, forward, the prefill and two decode
steps.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import quantized as jq
from repro.quant.policy import QuantPolicy as JPolicy
from repro_torch import configs as tconfigs
from repro_torch import random as prng
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import (
    decode_step,
    encode,
    forward,
    generate,
    init_cache,
    init_params,
    loss_fn,
    prefill,
    quantize_params,
)
from repro_torch.models.layers import KVCache
from repro_torch.models.quantized import QWeight
from repro_torch.quant.policy import QuantPolicy
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


ARCHS = ("whisper_tiny", "llama32_vision_11b")
VLM_CUT = "llama32_vision_11b_every_2"    # the vlm SMOKE config with cross_attn_every = 2
B, S = 2, 16
INIT_TOL = 1e-6
F32_TOL = 1e-5
BF16_TOL = 2e-2
FP, W4KV8 = (None, None), (4, 8)
XATTN_KEYS = ["attn", "ffn", "ln1", "ln2", "ln_x", "xattn"]


def _cfgs(arch, dtype="float32"):
    cut = arch == VLM_CUT
    arch = "llama32_vision_11b" if cut else arch
    extra = {"cross_attn_every": 2} if cut else {}
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype, **extra),
            dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype, **extra))


def _j(a):
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


def _numpy_tree(tree):
    """numpy leaves in the tree's own order of keys; a QWeight or a KV cache
    as a namespace of its arrays (None kept)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jq.QWeight):
        return types.SimpleNamespace(packed=np.asarray(tree.packed),
                                     scale=np.asarray(tree.scale), bits=tree.bits,
                                     k_dim=tree.k_dim)
    if hasattr(tree, "_fields"):
        return types.SimpleNamespace(**{f: None if getattr(tree, f) is None else
                                        np.asarray(getattr(tree, f)) for f in tree._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return np.asarray(tree)


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, pre + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, pre + (i,))]
    return [(pre, tree)]


def _close(name, got, want, tol, scale=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{name}: max |Δ| / max|reference| = {err:.3g} > {tol}"


@pytest.fixture(scope="module")
def reference_params():
    """The reference's parameters of each arch from PRNGKey(0), float32 and
    W4 (nearest codes, so the order of keys does not matter and jit may sort
    them); the cut vlm's float32 only."""
    quantize = jax.jit(lambda p: jq.quantize_params(p, 4))
    out = {}
    for arch in ARCHS + (VLM_CUT,):
        with jax.threefry_partitionable(True):
            params = jmodel.init_params(_cfgs(arch)[0], jax.random.PRNGKey(0))
        out[arch] = {FP: params} if arch == VLM_CUT else {FP: params, W4KV8: quantize(params)}
    return out


def _source(cfg):
    """Stub frames (encdec: encoder_seq of them) or image embeddings (vlm:
    n_image_tokens rows), float32, from a seed."""
    t = cfg.encoder_seq if cfg.family == "encdec" else cfg.n_image_tokens
    return np.random.default_rng(1).standard_normal((B, t, cfg.d_model)).astype(np.float32)


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 2)).astype(np.int32)


def _xattn_slot(cfg):
    return f"slot{cfg.pattern_for_layers().index('xattn')}"


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_is_the_reference_tree(reference_params, arch):
    """Keys, nesting, order and values, the encoder's stacked "attn" blocks
    and final norm and the "xattn" blocks' ln_x and xattn leaves included."""
    cfg = _cfgs(arch)[1]
    pj = _numpy_tree(reference_params[arch][FP])
    pt = init_params(cfg, prng.PRNGKey(0), device="cpu")
    lj, lt = _paths(pj), _paths(pt)
    assert [p for p, _ in lt] == [p for p, _ in lj]       # keys, nesting and order
    block = pt["slots"][_xattn_slot(cfg)]
    assert list(block) == XATTN_KEYS and list(block["xattn"]) == ["wk", "wo", "wq", "wv"]
    if cfg.family == "encdec":
        enc = pt["encoder"]
        assert list(enc) == ["blocks", "final_norm"]
        assert enc["blocks"]["attn"]["wq"]["w"].shape == (cfg.n_encoder_layers, 64, 64)
    else:
        assert "encoder" not in pt and list(pt["slots"]) == [f"slot{j}" for j in range(5)]
    for (path, a), (_, b) in zip(lj, lt):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, path
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=INIT_TOL, err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_codes_bit_for_bit(reference_params, arch):
    """W4 nearest codes and scales of every 2-D ``w`` outside ``embed``: the
    encoder's, the cross-attention's and the unembedding's too."""
    qj = _numpy_tree(reference_params[arch][W4KV8])
    qt = quantize_params(lm_params_from_numpy(_numpy_tree(reference_params[arch][FP]), "cpu"), 4)
    lj, lt = dict(_paths(qj)), dict(_paths(qt))
    assert set(lj) == set(lt)
    for path, a in lj.items():
        b = lt[path]
        if isinstance(a, types.SimpleNamespace):
            assert isinstance(b, QWeight), path
            assert np.array_equal(b.packed.numpy(), a.packed), path
            assert np.array_equal(b.scale.numpy(), a.scale), path
        else:
            assert isinstance(b, torch.Tensor) and np.array_equal(b.numpy(), a), path
    xattn = qt["slots"][_xattn_slot(_cfgs(arch)[1])]["xattn"]
    assert all(isinstance(xattn[k]["w"], QWeight) for k in ("wq", "wk", "wv", "wo"))
    assert isinstance(qt["unembed"]["w"], QWeight) and isinstance(qt["embed"]["w"], torch.Tensor)
    if arch == "whisper_tiny":
        assert isinstance(qt["encoder"]["blocks"]["ffn"]["wi"]["w"], QWeight)


_REFERENCE_RUNS = {}


def _reference_run(cfg, params, tokens, source, bits):
    """The memory (encode's output, or the embeddings), teacher-forced
    logits over S + 2 tokens, the prefill's logits over S, the cache after
    it (numpy) and two decode steps' logits, in one jit."""
    policy = JPolicy(weight_bits=bits[0], kv_bits=bits[1])

    def run(p, toks, src):
        mem = jmodel.encode(cfg, p, src, policy) if cfg.family == "encdec" else src
        full, _ = jmodel.forward(cfg, p, toks, policy=policy, memory=mem)
        cache = jmodel.init_cache(cfg, B, S + 8, policy, mem_len=mem.shape[1])
        lp, cache = jmodel.prefill(cfg, p, toks[:, :S], cache, policy=policy, memory=mem)
        ld0, after = jmodel.decode_step(cfg, p, toks[:, S], cache, policy=policy)
        ld1, _ = jmodel.decode_step(cfg, p, toks[:, S + 1], after, policy=policy,
                                    position=jnp.asarray(S + 1, dtype=jnp.int32))
        return mem, full, lp, cache, ld0, ld1

    compiled = jax.jit(run)
    mem, full, lp, cache, ld0, ld1 = compiled(params, _j(tokens), _j(source))
    return {"memory": np.asarray(mem, np.float32), "forward": np.asarray(full, np.float32),
            "prefill": np.asarray(lp, np.float32), "cache": _numpy_tree(cache),
            "steps": [np.asarray(ld0, np.float32), np.asarray(ld1, np.float32)]}


# (arch, dtype, weight and KV bits, tolerance) of each case
CASES = {f"{arch}-{name}": (arch,) + case for arch in ARCHS for name, case in (
    ("float32", ("float32", FP, F32_TOL)), ("float32_w4kv8", ("float32", W4KV8, F32_TOL)),
    ("bfloat16_w4kv8", ("bfloat16", W4KV8, BF16_TOL)))}
CASES[f"{VLM_CUT}-float32"] = (VLM_CUT, "float32", FP, F32_TOL)


def _hold(reference_params, case):
    """The port's encode, forward, prefill and two decode steps against the
    reference's (one reference run per case, reused), and its cross K/V
    against the reference's cache after the prefill. Returns the reference
    run, the port's parameters and cache after the prefill, and the
    port's forward and prefill logits."""
    arch, dtype, bits, tol = CASES[case]
    cfg_j, cfg = _cfgs(arch, dtype)
    pj = reference_params[arch][bits]
    pt = lm_params_from_numpy(_numpy_tree(pj), "cpu")
    tokens, source = _tokens(cfg), _source(cfg)
    if case not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[case] = _reference_run(cfg_j, pj, tokens, source, bits)
    want = _REFERENCE_RUNS[case]
    policy = QuantPolicy(weight_bits=bits[0], kv_bits=bits[1])
    toks, mem = torch.from_numpy(tokens), torch.from_numpy(source)
    if cfg.family == "encdec":
        mem = encode(cfg, pt, mem, policy)
        assert mem.dtype == getattr(torch, dtype) and mem.shape == (B, cfg.encoder_seq, 64)
        _close("encode", mem.float().numpy(), want["memory"], tol)
    full, aux = forward(cfg, pt, toks, policy=policy, memory=mem)
    assert float(aux["moe_load_loss"]) == 0.0
    scale = float(np.abs(want["forward"]).max())
    _close("forward", full.float().numpy(), want["forward"], tol, scale)
    cache = init_cache(cfg, B, S + 8, policy, mem_len=mem.shape[1], device="cpu")
    logits, cache = prefill(cfg, pt, toks[:, :S], cache, policy=policy, memory=mem)
    _close("prefill", logits.float().numpy(), want["prefill"], tol, scale)
    slot = _xattn_slot(cfg)
    for name in ("ck", "cv"):
        got = cache["slots"][slot][name]
        assert got.dtype == getattr(torch, dtype)
        _close(f"cached {name}", got.float().numpy(), want["cache"]["slots"][slot][name], tol)
    prefilled = {k: v.clone() for k, v in cache["slots"][slot].items() if k != "self"}
    for i in range(2):
        ld, cache = decode_step(cfg, pt, toks[:, S + i], cache, policy=policy)
        _close(f"decode step {i}", ld.float().numpy(), want["steps"][i], tol, scale)
    assert cache["slots"][slot]["self"].length == S + 2
    assert all(torch.equal(cache["slots"][slot][k], v) for k, v in prefilled.items())
    return want, pt, full, logits


@pytest.mark.parametrize("case", list(CASES))
def test_logits(reference_params, case):
    _hold(reference_params, case)


@pytest.mark.parametrize("case", [c for c in CASES if c.endswith("float32_w4kv8")])
def test_decode_continues_from_the_reference_cache(reference_params, case):
    """The reference's own cache after the prefill (int8 self K/V, float
    cross K/V), carried across by lm_cache_from_numpy: the port's decode
    steps from it give the reference's logits."""
    want, pt, _, _ = _hold(reference_params, case)
    arch, dtype, bits, tol = CASES[case]
    cfg = _cfgs(arch, dtype)[1]
    policy = QuantPolicy(weight_bits=bits[0], kv_bits=bits[1])
    cache = lm_cache_from_numpy(want["cache"], "cpu")
    entry = cache["slots"][_xattn_slot(cfg)]
    assert sorted(entry) == ["ck", "cv", "self"] and isinstance(entry["self"], KVCache)
    assert entry["self"].length == S and entry["self"].k.dtype == torch.int8
    tokens = torch.from_numpy(_tokens(cfg))
    scale = float(np.abs(want["forward"]).max())
    for i in range(2):
        ld, cache = decode_step(cfg, pt, tokens[:, S + i], cache, policy=policy)
        _close(f"decode step {i}", ld.float().numpy(), want["steps"][i], tol, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_against_forward_as_the_reference(reference_params, arch):
    """In float32 the prefill's logits sit as far from ``forward``'s in both
    packages: for whisper-tiny ~1e-4 of max|logits| (both prefills apply
    RoPE to the decoder's self-attention, both ``forward``s do not), for the
    vlm at float32 rounding."""
    case = f"{arch}-float32"
    want, _, full, logits = _hold(reference_params, case)
    scale = float(np.abs(want["forward"]).max())
    gap_ref = float(np.abs(want["prefill"] - want["forward"][:, S - 1]).max()) / scale
    gap_port = float((logits - full[:, S - 1]).abs().max()) / scale
    print(f"prefill vs forward, {arch}: reference {gap_ref:.3g}, port {gap_port:.3g}")
    assert abs(gap_port - gap_ref) <= F32_TOL
    if arch == "whisper_tiny":
        assert 1e-5 < gap_ref < 2e-2 and 0.5 < gap_port / gap_ref < 2
    else:
        assert gap_ref <= 1e-6 and gap_port <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_memory_is_required(arch):
    """forward and prefill raise a ValueError without a memory; a cache
    sized for another memory length raises in the prefill; loss_fn raises
    the same ValueError without a memory and with one returns a finite
    loss (both families train)."""
    cfg = _cfgs(arch)[1]
    params = init_params(cfg, prng.PRNGKey(0), device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    what = "encode" if cfg.family == "encdec" else "image embeddings"
    with pytest.raises(ValueError, match=f"forward: the {cfg.family} family .*{what}"):
        forward(cfg, params, toks)
    cache = init_cache(cfg, 1, 8, mem_len=5, device="cpu")
    with pytest.raises(ValueError, match=f"prefill: the {cfg.family} family"):
        prefill(cfg, params, toks, cache)
    mem = torch.zeros((1, 6, cfg.d_model))
    with pytest.raises(ValueError, match="mem_len=6"):
        prefill(cfg, params, toks, cache, memory=mem)
    with pytest.raises(ValueError, match=f"loss_fn: the {cfg.family} family .*{what}"):
        loss_fn(cfg, params, {"tokens": toks, "labels": toks})
    loss = loss_fn(cfg, params, {"tokens": toks, "labels": toks, "memory": mem})
    assert loss.shape == () and bool(torch.isfinite(loss))


def test_generate_with_memory():
    """generate over the encoder's memory sizes the cross cache by it and
    takes 4 greedy tokens; its decode logits agree with the decode steps'
    own teacher-forced replay."""
    cfg = _cfgs("whisper_tiny")[1]
    params = init_params(cfg, prng.PRNGKey(0), device="cpu")
    mem = encode(cfg, params, torch.from_numpy(_source(cfg)))
    prompt = torch.from_numpy(_tokens(cfg)[:, :S]).long()
    toks, logits = generate(cfg, params, prompt, 4, memory=mem)
    assert toks.shape == (B, 4) and torch.equal(toks, logits.argmax(-1))
    cache = init_cache(cfg, B, S + 8, mem_len=mem.shape[1], device="cpu")
    lp, cache = prefill(cfg, params, prompt, cache, memory=mem)
    replay = [lp]
    for i in range(3):
        ld, cache = decode_step(cfg, params, toks[:, i], cache)
        replay.append(ld)
    _close("generate vs replay", logits.numpy(), torch.stack(replay, 1).numpy(), F32_TOL)
