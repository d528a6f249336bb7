"""repro_torch.models' layers, quantized weights and configs against
repro.models on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: configs equal; quantized codes, packed bytes and scales (nearest,
and stochastic from one key) bit for bit, and so are the int8 KV codes;
float layers within 1e-5 (abs and rel) in float32, the order of float
operations being the only difference.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jl
from repro.models import quantized as jq
from repro_torch import configs as tconfigs
from repro_torch import random as prng
from repro_torch.models import layers as tl
from repro_torch.models import model as tmodel
from repro_torch.models import quantized as tq


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


TOL = 1e-5
ARCHS = jconfigs.ARCH_IDS


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    """The port reproduces jax.random under jax_threefry_partitionable=True."""
    with jax.threefry_partitionable(True):
        yield


def _j(a):
    """A JAX array of numpy's array, its dtype kept."""
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor) else got),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        cj, ct = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
        assert dataclasses.asdict(cj) == dataclasses.asdict(ct)
        assert cj.param_count() == ct.param_count()
        assert cj.active_param_count() == ct.active_param_count()
        assert cj.pattern_for_layers() == ct.pattern_for_layers()
        for sj, st in zip(jconfigs.ALL_SHAPES, tconfigs.ALL_SHAPES):
            assert dataclasses.asdict(sj) == dataclasses.asdict(st)
            assert jconfigs.applicable(cj, sj) == tconfigs.applicable(ct, st)


def test_registry_resolves_the_reference_aliases():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert set(tconfigs.BY_NAME) == set(jconfigs.BY_NAME)
    for alias in jconfigs.ALIASES:
        assert tconfigs.resolve(alias) == jconfigs.resolve(alias)
    assert tconfigs.get_config("starcoder2-3b").name == "starcoder2-3b"
    assert tconfigs.get_config("starcoder2-3b").param_count() == 3_369_074_688


def test_torch_dtype():
    from repro_torch.models.config import torch_dtype

    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        torch_dtype("int8")


# ---------------------------------------------------------------------------
# quantized weights, bit for bit


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_weight_bitwise(bits, stochastic):
    w = _rng(bits).standard_normal((3, 40, 24)).astype(np.float32)   # (L, in, out)
    jkey = jax.random.PRNGKey(7) if stochastic else None
    tkey = prng.PRNGKey(7) if stochastic else None
    qj = jq.quantize_weight(_j(w), bits, jkey)
    qt = tq.quantize_weight(_t(w), bits, tkey)
    assert (qt.bits, qt.k_dim) == (qj.bits, qj.k_dim)
    np.testing.assert_array_equal(qt.packed.numpy(), np.asarray(qj.packed))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    np.testing.assert_array_equal(qt.dequantize().numpy(), np.asarray(qj.dequantize()))
    np.testing.assert_array_equal(qt[1].dequantize().numpy(), np.asarray(qj.dequantize())[1])
    pw = qt[2].packed_weights()
    assert pw.scale.shape == (1, 24) and pw.packed.shape == (24, qt.packed.shape[-1])


@pytest.fixture(scope="module")
def smoke_trees():
    """SMOKE parameters of two dense archs (gelu, swiglu) from the port's
    init_params (test_torch_lm_model.py holds them to the reference's), and
    the same tree as JAX arrays in the same order of keys."""
    out = {}
    for arch in ("starcoder2_3b", "qwen1_5_32b"):
        pt = tmodel.init_params(tconfigs.get_smoke_config(arch), prng.PRNGKey(0), device="cpu")
        out[arch] = (_jax_tree(pt), pt)
    return out


def _jax_tree(tree):
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax_tree(v) for v in tree)
    return _j(tree.numpy())


def _numpy_tree(tree):
    """numpy leaves in the tree's own order of keys (jax.tree_util.tree_map
    would sort them, and quantize_params counts keys in order)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if isinstance(tree, jq.QWeight):
        return types.SimpleNamespace(packed=np.asarray(tree.packed),
                                     scale=np.asarray(tree.scale), bits=tree.bits,
                                     k_dim=tree.k_dim)
    return np.asarray(tree)


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, pre + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, pre + (i,))]
    return [(pre, tree)]


@pytest.mark.parametrize("arch,bits,stochastic", [("starcoder2_3b", 4, True),
                                                  ("starcoder2_3b", 8, False),
                                                  ("qwen1_5_32b", 2, True)])
def test_quantize_params_bitwise(smoke_trees, arch, bits, stochastic):
    """Every kernel's codes and scales, in the reference's order of keys:
    the stochastic key of kernel i is fold_in(key, i) in that order."""
    pj, pt = smoke_trees[arch]
    # jit over the closed-over tree: the reference walks its own order of
    # keys inside (a jit argument would be rebuilt with sorted keys)
    quantize = jax.jit(lambda: jq.quantize_params(pj, bits, jax.random.PRNGKey(3), stochastic))
    qj = _numpy_tree(quantize())
    qt = tq.quantize_params(pt, bits, prng.PRNGKey(3), stochastic)
    assert [p for p, _ in _paths(pt)] == [p for p, _ in _paths(_numpy_tree(pj))]
    n_q = 0
    for path, b in _paths(qt):
        a = qj
        for k in path:
            a = a[k]
        if isinstance(a, types.SimpleNamespace):
            n_q += 1
            assert isinstance(b, tq.QWeight) and (b.bits, b.k_dim) == (a.bits, a.k_dim), path
            np.testing.assert_array_equal(b.packed.numpy(), a.packed, err_msg=str(path))
            np.testing.assert_array_equal(b.scale.numpy(), a.scale, err_msg=str(path))
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=str(path))
    assert n_q == (7 if arch == "starcoder2_3b" else 8)    # unembed + 4 attn + the MLP's
    nearest = jax.jit(lambda: jq.quantize_params(pj, bits))
    assert tq.param_bytes(qt) == jq.param_bytes(nearest())
    assert tq.param_bytes(pt) == jq.param_bytes(pj)


# ---------------------------------------------------------------------------
# KV cache


def test_quantize_kv_codes_bitwise():
    x = _rng(1).standard_normal((2, 3, 5, 16)).astype(np.float32) * 3
    x[0, 0, 0] = 0.0                                   # an all-zero row: the 1e-6 floor
    cj, sj = jl._quantize_kv(_j(x), 8)
    ct, st = tl._quantize_kv(_t(x), 8)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tl._dequantize_kv(ct, st, 8, torch.float32).numpy(),
                                  np.asarray(jl._dequantize_kv(cj, sj, 8, jnp.float32)))


@pytest.mark.parametrize("kv_bits", [None, 8])
def test_cache_update_and_read(kv_bits):
    rng = _rng(2)
    cj = jl.init_kv_cache(2, 2, 12, 16, jnp.float32, kv_bits)
    ct = tl.init_kv_cache(2, 2, 12, 16, torch.float32, kv_bits, device="cpu")
    for t in (5, 1, 1):
        k = rng.standard_normal((2, 2, t, 16)).astype(np.float32)
        v = rng.standard_normal((2, 2, t, 16)).astype(np.float32)
        cj = jl.cache_update(cj, _j(k), _j(v), kv_bits)
        ct = tl.cache_update(ct, _t(k), _t(v), kv_bits)
        assert ct.length == int(cj.length)
        for a, b in zip(tl.cache_kv(ct, kv_bits, torch.float32),
                        jl.cache_kv(cj, kv_bits, jnp.float32)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="do not fit"):
        tl.cache_update(ct._replace(length=12), _t(k), _t(v), kv_bits)


@pytest.mark.parametrize("kv_bits", [None, 8])
@pytest.mark.parametrize("prompt", [3, 6, 9])
def test_cache_update_window(kv_bits, prompt):
    """Ring semantics of the local-attention cache: a prompt longer, shorter
    or equal to the window, then single tokens past the point it is full."""
    window, rng = 6, _rng(prompt)
    cj = jl.init_kv_cache(1, 1, window, 8, jnp.float32, kv_bits)
    ct = tl.init_kv_cache(1, 1, window, 8, torch.float32, kv_bits, device="cpu")
    for t in (prompt, 1, 1, 1, 1):
        k = rng.standard_normal((1, 1, t, 8)).astype(np.float32)
        v = rng.standard_normal((1, 1, t, 8)).astype(np.float32)
        cj = jl.cache_update_window(cj, _j(k), _j(v), window, kv_bits)
        ct = tl.cache_update_window(ct, _t(k), _t(v), window, kv_bits)
        assert ct.length == int(cj.length)
        assert tl.window_valid_length(ct, window) == int(jl.window_valid_length(cj, window))
        for a, b in zip(tl.cache_kv(ct, kv_bits, torch.float32),
                        jl.cache_kv(cj, kv_bits, jnp.float32)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# float layers


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm(norm_type):
    rng = _rng(3)
    x = (rng.standard_normal((2, 5, 32)) * 2 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    want = jl.apply_norm({k: _j(v) for k, v in p.items()}, _j(x),
                         norm_type, 1e-5)
    got = tl.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), norm_type, 1e-5)
    _close(got, want)
    got16 = tl.apply_norm({k: _t(v) for k, v in p.items()}, _t(x).bfloat16(), norm_type, 1e-5)
    assert got16.dtype == torch.bfloat16


def test_rope_and_sinusoids():
    rng = _rng(4)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 100]).astype(np.int32)
    _close(tl.rope(_t(x), _t(pos), 10_000.0), jl.rope(_j(x), _j(pos), 10_000.0))
    _close(tl.sinusoidal_positions(9, 16), jl.sinusoidal_positions(9, 16))
    _close(tl.sinusoidal_at(5, 16), jl.sinusoidal_at(_j(5), 16))


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
def test_mlp_and_dense(mlp_type):
    """The MLP of each type on the port's mlp_init weights (with a bias on one
    product), and the same through 4-bit kernels."""
    pt = tl.mlp_init(prng.PRNGKey(5), 32, 48, mlp_type, device="cpu")
    first = "wi_gate" if mlp_type == "swiglu" else "wi"
    pt[first]["b"] = torch.linspace(-0.1, 0.1, 48)
    pj = _jax_tree(pt)
    x = _rng(5).standard_normal((2, 3, 32)).astype(np.float32)
    ref = jax.jit(lambda p, x: jl.mlp_apply(p, x, mlp_type))
    _close(tl.mlp_apply(pt, _t(x), mlp_type), ref(pj, _j(x)))
    quantize = jax.jit(lambda: {k: {**v, "w": jq.quantize_weight(v["w"], 4)}
                                for k, v in pj.items()})
    qj = quantize()
    qt = {k: {**v, "w": tq.quantize_weight(v["w"], 4)} for k, v in pt.items()}
    _close(tl.mlp_apply(qt, _t(x), mlp_type), ref(qj, _j(x)))


ATTN_CASES = [  # (hq, hkv, sq, sk, causal, window, q_offset, chunk)
    (4, 2, 16, 16, True, None, 0, 8),
    (4, 4, 12, 12, True, 5, 0, 4),
    (4, 1, 8, 20, False, None, 0, 8),
    (2, 2, 6, 6, True, None, 10, 6),
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention(case):
    hq, hkv, sq, sk, causal, window, q_offset, chunk = case
    rng = _rng(sq + sk)
    q = rng.standard_normal((2, hq, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, hkv, sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, hkv, sk, 16)).astype(np.float32)
    want = jl.chunked_attention(_j(q), _j(k), _j(v), causal=causal,
                                chunk=chunk, window=window, q_offset=q_offset)
    got = tl.chunked_attention(_t(q), _t(k), _t(v), causal=causal, chunk=chunk, window=window,
                               q_offset=q_offset)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 4])
def test_decode_attention(window):
    rng = _rng(6)
    q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 10, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 10, 16)).astype(np.float32)
    want = jl.decode_attention(_j(q), _j(k), _j(v),
                               length=_j(7), window=window)
    got = tl.decode_attention(_t(q), _t(k), _t(v), length=7, window=window)
    _close(got, want)


def test_unported_blocks_raise():
    """Every block kind of the reference is ported ('xattn':
    tests/test_torch_xattn.py; 'rec', 'ssm': tests/test_torch_hybrid.py,
    tests/test_torch_ssm.py), and so is the mixture-of-experts FFN of
    qwen3-moe (tests/test_torch_moe.py): its block draws the router and the
    expert stacks. An unknown kind raises as in the reference."""
    cfg = tconfigs.get_smoke_config("qwen3_moe_30b")
    ffn = tmodel._block_init(prng.PRNGKey(0), cfg, "attn", device="cpu")["ffn"]
    assert ffn["router"]["w"].shape == (cfg.d_model, cfg.n_experts)
    assert ffn["wi_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert ffn["wo"].shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    cfg = tconfigs.get_smoke_config("llama32_vision_11b")
    with pytest.raises(ValueError, match="cross"):
        tmodel._block_init(prng.PRNGKey(0), cfg, "cross", device="cpu")
