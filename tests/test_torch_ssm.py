"""repro_torch.models' SSM family (mamba2-370m: the SSD blocks of
models/ssm.py) against repro.models on the CPU.

The SMOKE config: 2 layers, d = 64, d_inner 128 in 8 heads of 16, state 16,
conv 4, chunk 16; B = 2. A prompt of 48 tokens (three chunks chain) and 4
decode steps; ``forward`` over 52 tokens (its last chunk padded).

Tolerances, as tests/test_torch_hybrid.py states them: initial weights
within 1e-6 (the port's threefry normals differ from JAX's only in the order
of the erfinv polynomial's float operations); the block and the logits of
the float32 variant within 1e-5·max|reference| (the port contracts the
reference's four-operand einsums as two-operand ones, in another order of
sums); logits of the bfloat16 SMOKE config under W4 within 2e-2·max|logits|
(bfloat16 rounds at other places in the two packages). Quantized codes and
scales bit for bit. Each reference function is compiled once per case.
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
from repro.models import ssm as jssm
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
from repro_torch.models import ssm as tssm
from repro_torch.models.quantized import QWeight
from repro_torch.quant.policy import QuantPolicy


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


ARCH = "mamba2_370m"
B = 2
PROMPT, STEPS = 48, 4
T = PROMPT + STEPS
INIT_TOL = 1e-6
F32_TOL = 1e-5
BF16_TOL = 2e-2
FP, W4 = None, 4
SSM_KEYS = ["a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "in_proj", "norm_scale",
            "out_proj"]


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype))


def _j(a):
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


def _numpy_tree(tree):
    """numpy leaves in the tree's own order of keys; a QWeight or a
    recurrent state as a namespace of its arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, jq.QWeight):
        return types.SimpleNamespace(packed=np.asarray(tree.packed),
                                     scale=np.asarray(tree.scale), bits=tree.bits,
                                     k_dim=tree.k_dim)
    if hasattr(tree, "_fields"):
        return types.SimpleNamespace(**{f: np.asarray(getattr(tree, f)) for f in tree._fields})
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
    """The reference's parameters from PRNGKey(0), float32 and W4 (nearest
    codes, so the order of keys does not matter and jit may sort them)."""
    with jax.threefry_partitionable(True):
        params = jmodel.init_params(_cfgs()[0], jax.random.PRNGKey(0))
    quantize = jax.jit(lambda p: jq.quantize_params(p, 4))
    return {FP: params, W4: quantize(params)}


def test_init_params_is_the_reference_tree(reference_params):
    pj = _numpy_tree(reference_params[FP])
    pt = init_params(_cfgs()[1], prng.PRNGKey(0), device="cpu")
    lj, lt = _paths(pj), _paths(pt)
    assert [p for p, _ in lt] == [p for p, _ in lj]       # keys, nesting and order
    block = pt["slots"]["slot0"]
    assert list(block) == ["ln1", "ssm"] and list(block["ssm"]) == SSM_KEYS   # no ln2, no ffn
    assert pt["tail"] == [] and block["ssm"]["in_proj"]["w"].shape == (2, 64, 2 * 128 + 32 + 8)
    for (path, a), (_, b) in zip(lj, lt):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, path
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=INIT_TOL, err_msg=str(path))


def test_quantize_params_codes_bit_for_bit(reference_params):
    """W4 nearest codes and scales of in_proj and out_proj (and the
    embeddings'); conv_w, conv_b, a_log, d_skip, dt_bias and norm_scale
    stay dense."""
    qj = _numpy_tree(reference_params[W4])
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
    ssm = qt["slots"]["slot0"]["ssm"]
    assert [k for k, v in ssm.items() if isinstance(v, torch.Tensor)] == [
        "a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "norm_scale"]
    assert all(isinstance(ssm[k]["w"], QWeight) for k in ("in_proj", "out_proj"))


def _layer0(reference_params):
    pj = jax.tree_util.tree_map(lambda a: a[0], reference_params[FP]["slots"]["slot0"]["ssm"])
    return pj, lm_params_from_numpy(_numpy_tree(pj), "cpu")


@pytest.mark.parametrize("s", [48, 40, 8], ids=["3_chunks", "padded", "below_a_chunk"])
def test_ssd_apply(reference_params, s):
    """The chunked block over S tokens against the reference's (float32):
    three chunks chained, S = 40 padded to 48, and S = 8 in one chunk of 8."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _layer0(reference_params)
    u = np.random.default_rng(s).standard_normal((B, s, 64)).astype(np.float32)
    apply = jax.jit(lambda p, u: jssm.ssd_apply(p, u, cfg_j))
    want = apply(pj, _j(u))
    _close(f"ssd_apply S={s}", tssm.ssd_apply(pt, torch.from_numpy(u), cfg_t).numpy(), want,
           F32_TOL)


def test_ssd_decode_step(reference_params):
    """Two recurrent steps from a state of random values (conv inputs and SSM
    state), against the reference's: the outputs, the SSM state and the new
    conv state (its first row, carried over from the given state, bit for
    bit)."""
    cfg_j, cfg_t = _cfgs()
    pj, pt = _layer0(reference_params)
    rng = np.random.default_rng(5)
    conv = rng.standard_normal((B, 3, 128 + 32)).astype(np.float32)
    st = rng.standard_normal((B, 8, 16, 16)).astype(np.float32)
    steps = rng.standard_normal((2, B, 1, 64)).astype(np.float32)

    def run_j(p, conv, st, steps):
        state, ys = jssm.SSMState(conv, st), []
        for u in steps:
            y, state = jssm.ssd_decode_step(p, u, state, cfg_j)
            ys.append(y)
        return ys, state
    run_j = jax.jit(run_j)
    want_ys, want_state = run_j(pj, _j(conv), _j(st), _j(steps))
    state = tssm.SSMState(torch.from_numpy(conv), torch.from_numpy(st))
    for i, (u, w) in enumerate(zip(steps, want_ys)):
        y, state = tssm.ssd_decode_step(pt, torch.from_numpy(u), state, cfg_t)
        _close(f"decode step {i}", y.numpy(), w, F32_TOL)
    _close("ssm state", state.ssm.numpy(), want_state.ssm, F32_TOL)
    _close("conv state", state.conv.numpy(), want_state.conv, F32_TOL)
    np.testing.assert_array_equal(state.conv[:, 0].numpy(), conv[:, 2])


def test_prefill_state_is_the_recurrence(reference_params):
    """The port's own consistency: the chunk loop's final state after 48
    tokens (three chunks) is the decode step's recurrence over the same
    tokens, and so are the outputs."""
    cfg = _cfgs()[1]
    _, pt = _layer0(reference_params)
    u = torch.from_numpy(np.random.default_rng(7).standard_normal((B, 48, 64)).astype(np.float32))
    y, xbc_in, final = tssm.ssd_sequence(pt, u, cfg)
    state = tssm.init_ssm_state(B, cfg, "cpu")
    ys = []
    for t in range(48):
        yt, state = tssm.ssd_decode_step(pt, u[:, t:t + 1], state, cfg)
        ys.append(yt)
    _close("final state", final.numpy(), state.ssm.numpy(), F32_TOL)
    _close("outputs", y.numpy(), torch.cat(ys, 1).numpy(), F32_TOL)
    _close("conv inputs", xbc_in[:, -3:].numpy(), state.conv.numpy(), F32_TOL)


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


_REFERENCE_RUNS = {}


def _reference_run(cfg, params, tokens, bits):
    """Teacher-forced logits over T tokens, the prefill's logits over PROMPT,
    the cache after it (numpy), the decode steps' logits and the cache after
    the first step: forward and the prefill in one jit, the decode step in
    another, reused for every step."""
    policy = JPolicy(weight_bits=bits)

    def fwd_and_prefill(p, t):
        return jmodel.forward(cfg, p, t, policy=policy)[0], jmodel.prefill(
            cfg, p, t[:, :PROMPT], jmodel.init_cache(cfg, B, T + 8, policy), policy=policy)
    dec = jax.jit(lambda p, t, c, pos: jmodel.decode_step(cfg, p, t, c, policy=policy,
                                                          position=pos))
    fwd_and_prefill = jax.jit(fwd_and_prefill)
    full, (logits, cache) = fwd_and_prefill(params, _j(tokens))
    out = {"forward": np.asarray(full, np.float32), "prefill": np.asarray(logits, np.float32),
           "cache": _numpy_tree(cache), "steps": []}
    for i in range(STEPS):
        ld, cache = dec(params, _j(tokens[:, PROMPT + i]), cache,
                        jnp.asarray(PROMPT + i, jnp.int32))
        out["steps"].append(np.asarray(ld, np.float32))
        if i == 0:
            out["cache_after_step"] = _numpy_tree(cache)
    return out


# (dtype, weight bits, tolerance) of each case
CASES = {"float32": ("float32", FP, F32_TOL), "bfloat16_w4": ("bfloat16", W4, BF16_TOL)}


def _hold(reference_params, case):
    dtype, bits, tol = CASES[case]
    cfg_j, cfg_t = _cfgs(dtype)
    pj = reference_params[bits]
    pt = lm_params_from_numpy(_numpy_tree(pj), "cpu")
    tokens = _tokens(cfg_t)
    if case not in _REFERENCE_RUNS:
        _REFERENCE_RUNS[case] = _reference_run(cfg_j, pj, tokens, bits)
    want = _REFERENCE_RUNS[case]
    policy = QuantPolicy(weight_bits=bits)
    toks = torch.from_numpy(tokens)
    full, aux = forward(cfg_t, pt, toks, policy=policy)
    assert float(aux["moe_load_loss"]) == 0.0
    scale = float(np.abs(want["forward"]).max())
    _close("forward", full.float().numpy(), want["forward"], tol, scale)
    cache = init_cache(cfg_t, B, T + 8, policy, device="cpu")
    logits, cache = prefill(cfg_t, pt, toks[:, :PROMPT], cache, policy=policy)
    state = cache["slots"]["slot0"]
    assert isinstance(state, tssm.SSMState) and state.conv.dtype == torch.float32
    assert state.ssm.shape == (2, B, 8, 16, 16) and state.ssm.dtype == torch.float32
    _close("prefill", logits.float().numpy(), want["prefill"], tol, scale)
    served = [logits]
    for i in range(STEPS):
        ld, cache = decode_step(cfg_t, pt, toks[:, PROMPT + i], cache, policy=policy)
        _close(f"decode step {i}", ld.float().numpy(), want["steps"][i], tol, scale)
        served.append(ld)
    assert cache["slots"]["slot0"].conv.dtype == full.dtype
    # the serving path against the port's own teacher-forced logits
    served = torch.stack(served[:-1], 1).float().numpy()
    _close("served vs forward", served, full[:, PROMPT - 1:T - 1].float().numpy(), tol)
    return want, pt, tokens


@pytest.mark.parametrize("case", list(CASES))
def test_logits(reference_params, case):
    _hold(reference_params, case)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_continues_from_the_reference_cache(reference_params, case):
    """The reference's own cache after the 48-token prefill (its conv state
    float32), carried across by lm_cache_from_numpy: the port's decode steps
    from it give the reference's logits, and the conv slot takes the
    activations' dtype after a step, as the reference's."""
    want, pt, tokens = _hold(reference_params, case)
    dtype, bits, tol = CASES[case]
    cfg = _cfgs(dtype)[1]
    policy = QuantPolicy(weight_bits=bits)
    cache = lm_cache_from_numpy(want["cache"], "cpu")
    state = cache["slots"]["slot0"]
    assert isinstance(state, tssm.SSMState) and state.conv.dtype == torch.float32
    assert state.ssm.shape == (2, B, 8, 16, 16)
    scale = float(np.abs(want["forward"]).max())
    for i in range(STEPS):
        ld, cache = decode_step(cfg, pt, torch.from_numpy(tokens[:, PROMPT + i]), cache,
                                policy=policy)
        _close(f"decode step {i}", ld.float().numpy(), want["steps"][i], tol, scale)
        if i == 0:
            conv = cache["slots"]["slot0"].conv
            assert conv.dtype == getattr(torch, dtype)
            assert str(want["cache_after_step"]["slots"]["slot0"].conv.dtype) == dtype


@pytest.mark.parametrize("s", [40, 2])
def test_prefill_raises_where_the_reference_fails(s):
    """S = 40 is not a multiple of the chunk (16): the reference's prefill
    cannot reshape it. S = 2 < d_conv − 1: the reference's prefill leaves a
    conv state of 2 rows and its next decode step fails. The port raises a
    ValueError in prefill for both (traced shapes only, no compile)."""
    cfg_j, cfg_t = _cfgs()
    with jax.threefry_partitionable(True):
        pj = jax.eval_shape(lambda: jmodel.init_params(cfg_j, jax.random.PRNGKey(0)))
    toks = jnp.zeros((1, s), jnp.int32)
    cache_j = jax.eval_shape(lambda: jmodel.init_cache(cfg_j, 1, 64))
    with pytest.raises(TypeError, match="reshape"):
        _, cache_j = jax.eval_shape(lambda p, t, c: jmodel.prefill(cfg_j, p, t, c), pj, toks,
                                    cache_j)
        jax.eval_shape(lambda p, c: jmodel.decode_step(cfg_j, p, toks[:, 0], c,
                                                       position=s), pj, cache_j)
    pt = init_params(cfg_t, prng.PRNGKey(0), device="cpu")
    cache = init_cache(cfg_t, 1, 64, device="cpu")
    with pytest.raises(ValueError, match="multiple of" if s == 40 else "shorter than"):
        prefill(cfg_t, pt, torch.zeros((1, s), dtype=torch.int64), cache)


def test_generate():
    """generate from a 32-token prompt takes 6 tokens, greedy over logits
    that agree with forward (whose last chunk is padded)."""
    cfg = _cfgs()[1]
    params = init_params(cfg, prng.PRNGKey(0), device="cpu")
    prompt = torch.from_numpy(_tokens(cfg)[:, :32]).long()
    toks, logits = generate(cfg, params, prompt, 6, QuantPolicy())
    assert toks.shape == (B, 6) and torch.equal(toks, logits.argmax(-1))
    full, _ = forward(cfg, params, torch.cat([prompt, toks[:, :5]], dim=1))
    _close("generate vs forward", logits.numpy(), full[:, 31:].numpy(), F32_TOL)


def test_loss_fn_raises_for_the_ssm_family(reference_params):
    """loss_fn no longer raises for the ssm family: on 48 tokens (three of the 16-token chunks)
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
