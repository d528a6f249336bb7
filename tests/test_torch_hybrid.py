"""repro_torch.models' hybrid family (recurrentgemma-2b: the RG-LRU blocks
of models/rglru.py and local attention) against repro.models on the CPU.

The SMOKE config cut to 5 layers: one ("rec", "rec", "attn") period, stacked
as the reference stacks it, and a tail of two "rec" layers, so both places a
recurrent state lives are covered; window 32, B = 2. Prompts of 16 tokens
(shorter than the window) and 48 (longer: the ring cache keeps the last 32),
each followed by decode steps, the first one's past position 32, where the
ring starts to shift.

Tolerances, as tests/test_torch_lm_model.py states them for the dense
family: initial weights within 1e-6 (the port's threefry normals differ from
JAX's only in the order of the erfinv polynomial's float operations); logits
of the float32 variant within 1e-5·max|logits| (the port's log-depth scan
sums in another order than ``associative_scan``); logits of the bfloat16
SMOKE config under W4KV8 within 2e-2·max|logits| (bfloat16 rounds at other
places in the two packages). Quantized codes and scales bit for bit. Each
reference function is compiled once per case and reused across the steps.
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
from repro.models import rglru as jrglru
from repro.quant.policy import QuantPolicy as JPolicy
from repro_torch import configs as tconfigs
from repro_torch import random as prng
from repro_torch.convert import lm_cache_from_numpy, lm_params_from_numpy
from repro_torch.models import (
    decode_step,
    forward,
    generate,
    init_cache,
    init_params,
    loss_fn,
    prefill,
    quantize_params,
)
from repro_torch.models import rglru as trglru
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


ARCH = "recurrentgemma_2b"
N_LAYERS = 5                      # one period + a tail of two "rec" layers
B = 2
PROMPTS = {16: 20, 48: 4}         # prompt length -> decode steps after it
T = 52                            # tokens: the longest prompt + its steps
INIT_TOL = 1e-6
F32_TOL = 1e-5
BF16_TOL = 2e-2
FP, W4KV8 = (None, None), (4, 8)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), n_layers=N_LAYERS, dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), n_layers=N_LAYERS, dtype=dtype))


def _j(a):
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


def _numpy_tree(tree):
    """numpy leaves in the tree's own order of keys; a QWeight, a KV cache or
    a recurrent state as a namespace of its arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jq.QWeight):
        return types.SimpleNamespace(packed=np.asarray(tree.packed),
                                     scale=np.asarray(tree.scale), bits=tree.bits,
                                     k_dim=tree.k_dim)
    if hasattr(tree, "_fields"):
        return types.SimpleNamespace(**{f: None if getattr(tree, f) is None
                                        else np.asarray(getattr(tree, f))
                                        for f in tree._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return np.asarray(tree)


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, pre + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, pre + (i,))]
    return [(pre, tree)]


@pytest.fixture(scope="module")
def reference_params():
    """The reference's parameters from PRNGKey(0), float32 and W4 (nearest
    codes, so the order of keys does not matter and jit may sort them)."""
    with jax.threefry_partitionable(True):
        params = jmodel.init_params(_cfgs()[0], jax.random.PRNGKey(0))
    quantize = jax.jit(lambda p: jq.quantize_params(p, 4))
    return {FP: params, W4KV8: quantize(params)}


def test_init_params_is_the_reference_tree(reference_params):
    pj = _numpy_tree(reference_params[FP])
    pt = init_params(_cfgs()[1], prng.PRNGKey(0), device="cpu")
    lj, lt = _paths(pj), _paths(pt)
    assert [p for p, _ in lt] == [p for p, _ in lj]       # keys, nesting and order
    assert "rec" in pt["slots"]["slot0"] and "rec" in pt["tail"][1]
    for (path, a), (_, b) in zip(lj, lt):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, path
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=INIT_TOL, err_msg=str(path))


def test_quantize_params_codes_bit_for_bit(reference_params):
    """W4 nearest codes and scales of every kernel, the rec blocks' five
    products included; conv_w, conv_b and lambda_raw stay dense."""
    qj = _numpy_tree(reference_params[W4KV8])
    qt = quantize_params(lm_params_from_numpy(_numpy_tree(reference_params[FP]), "cpu"), 4)
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
    rec = qt["tail"][0]["rec"]
    assert [k for k, v in rec.items() if isinstance(v, torch.Tensor)] == [
        "conv_w", "conv_b", "lambda_raw"]
    assert all(isinstance(rec[k]["w"], QWeight) for k in ("in_x", "in_gate", "w_r", "w_i", "out"))


def test_rglru_apply_and_decode_step(reference_params):
    """The block over a sequence, then two decode steps from the state a
    prefill leaves, against the reference's functions (float32)."""
    pj = reference_params[FP]["tail"][0]["rec"]
    pt = lm_params_from_numpy(_numpy_tree(pj), "cpu")
    rng = np.random.default_rng(3)
    u = rng.standard_normal((B, 40, 64)).astype(np.float32)
    steps = rng.standard_normal((2, B, 1, 64)).astype(np.float32)

    def run_j(p, u, steps):
        y = jrglru.rglru_apply(p, u, 64)
        _, state = jmodel._rglru_prefill(p, u, None, jrglru.init_rglru_state(B, 64, 4))
        ys = []
        for s in steps:
            yd, state = jrglru.rglru_decode_step(p, s, state, 64)
            ys.append(yd)
        return y, ys, state
    run_j = jax.jit(run_j)
    want_y, want_steps, want_state = run_j(pj, _j(u), _j(steps))
    got_y = trglru.rglru_apply(pt, torch.from_numpy(u), 64)
    _, got_conv, got_h = trglru.rglru_sequence(pt, torch.from_numpy(u))
    state = trglru.RGLRUState(got_conv, got_h)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0,
                               atol=F32_TOL * float(np.abs(want_y).max()))
    for s, w in zip(steps, want_steps):
        yd, state = trglru.rglru_decode_step(pt, torch.from_numpy(s), state, 64)
        np.testing.assert_allclose(yd.numpy(), np.asarray(w), rtol=0,
                                   atol=F32_TOL * float(np.abs(w).max()))
    np.testing.assert_allclose(state.h.numpy(), np.asarray(want_state.h), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(state.conv.numpy(), np.asarray(want_state.conv))


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against h_t = a_t h_{t-1} + b_t step by step, at
    lengths around powers of two."""
    gen = torch.Generator().manual_seed(0)
    for s in (1, 2, 7, 8, 33):
        a = torch.rand(2, s, 3, generator=gen)
        b = torch.randn(2, s, 3, generator=gen)
        h, want = torch.zeros(2, 3), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(trglru.linear_scan(a, b), torch.stack(want, 1),
                                   rtol=1e-6, atol=1e-6)


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


_REFERENCE_RUNS = {}


def _reference_run(cfg, params, tokens, bits):
    """Teacher-forced logits over T tokens, and for each prompt of PROMPTS
    the prefill's logits, the decode steps' logits and the cache after the
    prefill (numpy): forward and the prefills in one jit, the decode step in
    another, reused for every step."""
    policy = JPolicy(weight_bits=bits[0], kv_bits=bits[1])

    def fwd_and_prefills(p, t):
        return jmodel.forward(cfg, p, t, policy=policy)[0], {
            s: jmodel.prefill(cfg, p, t[:, :s], jmodel.init_cache(cfg, B, T + 8, policy),
                              policy=policy) for s in PROMPTS}
    dec = jax.jit(lambda p, t, c, pos: jmodel.decode_step(cfg, p, t, c, policy=policy,
                                                          position=pos))
    fwd_and_prefills = jax.jit(fwd_and_prefills)
    full, prefills = fwd_and_prefills(params, _j(tokens))
    out = {"forward": np.asarray(full, np.float32)}
    for s, n in PROMPTS.items():
        logits, cache = prefills[s]
        first = _numpy_tree(cache)
        steps = []
        for i in range(n):
            ld, cache = dec(params, _j(tokens[:, s + i]), cache, jnp.asarray(s + i, jnp.int32))
            steps.append(np.asarray(ld, np.float32))
        out[s] = (np.asarray(logits, np.float32), steps, first)
    return out


def _port_run(cfg, params, tokens, bits):
    policy = QuantPolicy(weight_bits=bits[0], kv_bits=bits[1])
    toks = torch.from_numpy(tokens)
    full, aux = forward(cfg, params, toks, policy=policy)
    assert float(aux["moe_load_loss"]) == 0.0
    out = {"forward": full.float().numpy()}
    for s, n in PROMPTS.items():
        cache = init_cache(cfg, B, T + 8, policy, device="cpu")
        assert cache["slots"]["slot2"].k.shape[3] == cfg.local_window
        logits, cache = prefill(cfg, params, toks[:, :s], cache, policy=policy)
        for state in (cache["slots"]["slot0"], cache["tail"][1]):
            assert state.conv.dtype == full.dtype and state.h.dtype == torch.float32
        steps = []
        for i in range(n):
            ld, cache = decode_step(cfg, params, toks[:, s + i], cache, policy=policy)
            steps.append(ld.float().numpy())
        assert cache["slots"]["slot2"].length == s + n
        out[s] = (logits.float().numpy(), steps)
    return out


# (dtype, weight and KV bits, tolerance) of each case
CASES = {"float32": ("float32", FP, F32_TOL), "bfloat16_w4kv8": ("bfloat16", W4KV8, BF16_TOL)}


def _hold(reference_params, case):
    dtype, bits, tol = CASES[case]
    cfg_j, cfg_t = _cfgs(dtype)
    pj = reference_params[bits]
    pt = lm_params_from_numpy(_numpy_tree(pj), "cpu")
    tokens = _tokens(cfg_t)
    if case not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[case] = _reference_run(cfg_j, pj, tokens, bits)
    want = _REFERENCE_RUNS[case]
    got = _port_run(cfg_t, pt, tokens, bits)
    scale = float(np.abs(want["forward"]).max())

    def close(name, g, w):
        assert g.shape == w.shape and np.isfinite(g).all(), name
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{name}: max |Δ| / max|logits| = {err:.3g} > {tol}"
    close("forward", got["forward"], want["forward"])
    for s, n in PROMPTS.items():
        close(f"prefill {s}", got[s][0], want[s][0])
        for i in range(n):
            close(f"prompt {s} decode step {i}", got[s][1][i], want[s][1][i])
    # the serving path against the port's own teacher-forced logits (the
    # reference's consistency bound, tests/test_models_smoke.py)
    full = got["forward"]
    for s, n in PROMPTS.items():
        served = np.stack([got[s][0]] + got[s][1][:-1], axis=1)
        assert float(np.abs(served - full[:, s - 1:s + n - 1]).max()) / scale < BF16_TOL
    return want, pt, tokens


def test_float32_logits(reference_params):
    _hold(reference_params, "float32")


def test_bfloat16_w4kv8_logits(reference_params):
    _hold(reference_params, "bfloat16_w4kv8")


@pytest.mark.parametrize("case", list(CASES))
def test_decode_continues_from_the_reference_cache(reference_params, case):
    """The reference's own cache after a 48-token prefill (float KV or int8
    codes and scales; conv states in the activations' dtype), carried across
    by lm_cache_from_numpy: the port's decode steps from it give the
    reference's logits within the case's tolerance, ring full from the
    first step."""
    want, pt, tokens = _hold(reference_params, case)
    dtype, bits, tol = CASES[case]
    cfg = _cfgs(dtype)[1]
    policy = QuantPolicy(weight_bits=bits[0], kv_bits=bits[1])
    s, n = 48, PROMPTS[48]
    cache = lm_cache_from_numpy(want[s][2], "cpu")
    kv = cache["slots"]["slot2"]
    assert isinstance(kv, KVCache) and kv.length == s and kv.quantized == bool(bits[1])
    assert isinstance(cache["tail"][0], trglru.RGLRUState)
    assert cache["slots"]["slot0"].h.shape == (1, B, 64)
    assert cache["tail"][1].conv.dtype == getattr(torch, dtype)
    scale = float(np.abs(want["forward"]).max())
    for i in range(n):
        ld, cache = decode_step(cfg, pt, torch.from_numpy(tokens[:, s + i]), cache, policy=policy)
        err = float(np.abs(ld.float().numpy() - want[s][1][i]).max()) / scale
        assert err <= tol, f"decode step {i}: {err:.3g}"


def test_generate_crosses_the_window():
    """generate from a 30-token prompt takes 6 tokens, its decode steps past
    the window's 32 slots; greedy over logits that agree with forward."""
    cfg = _cfgs()[1]
    params = init_params(cfg, prng.PRNGKey(0), device="cpu")
    prompt = torch.from_numpy(_tokens(cfg)[:, :30]).long()
    toks, logits = generate(cfg, params, prompt, 6, QuantPolicy())
    assert torch.equal(toks, logits.argmax(-1))
    full, _ = forward(cfg, params, torch.cat([prompt, toks[:, :5]], dim=1))
    scale = float(full.abs().max())
    assert float((logits - full[:, 29:]).abs().max()) / scale <= F32_TOL


def test_loss_fn_raises_for_the_hybrid_family(reference_params):
    """loss_fn no longer raises for the hybrid family: on 48 tokens (past the window of 32)
    its float32 loss equals the reference's within 1e-5 (relative); its
    gradients are held in tests/test_torch_train_recurrent.py."""
    cfg_j, cfg_t = _cfgs()
    toks = _tokens(cfg_t)
    tokens, labels = toks[:, :48], toks[:, 1:49]
    reference_loss = jax.jit(lambda p, b: jmodel.loss_fn(cfg_j, p, b))
    want = float(reference_loss(reference_params[FP],
                                {"tokens": _j(tokens), "labels": _j(labels)}))
    params = lm_params_from_numpy(_numpy_tree(reference_params[FP]), "cpu")
    got = loss_fn(cfg_t, params, {"tokens": torch.from_numpy(tokens),
                                  "labels": torch.from_numpy(labels)})
    assert abs(float(got) - want) <= F32_TOL * want
    assert bool(torch.isfinite(got))
