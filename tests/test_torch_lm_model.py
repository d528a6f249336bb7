"""repro_torch.models' dense LM (init_params, forward, prefill, decode_step,
generate) against repro.models on the CPU, on the SMOKE configs of the four
dense archs: qwen1.5-32b (swiglu, RMSNorm, QKV bias, MHA), starcoder2-3b
(tanh-GELU, LayerNorm, QKV bias, GQA), minitron-4b (squared ReLU,
LayerNorm, GQA) and stablelm-12b (swiglu, LayerNorm, GQA), all at D = 16.

Tolerances: initial weights within 1e-6 (the port's threefry normals differ
from JAX's only in the order of the erfinv polynomial's float operations);
logits of the float32 variant (``dtype="float32"``) within 1e-5·max|logits|,
full precision and quantized (W8/W4 codes and KV8, carried across from the
reference's tree so that both compute on the same bytes); logits of the
bfloat16 SMOKE configs within 2e-2·max|logits| (bfloat16 rounds at other
places in the two packages), the bound of the reference's own prefill/decode
consistency test. Each reference function is compiled once per case: one
jit runs forward, prefill and two decode steps.
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
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import (
    decode_step,
    forward,
    generate,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)
from repro_torch.quant.policy import QuantPolicy


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


DENSE = ("qwen1_5_32b", "starcoder2_3b", "minitron_4b", "stablelm_12b")
B, S = 2, 16
INIT_TOL = 1e-6
F32_TOL = 1e-5
BF16_TOL = 2e-2
FP, W8KV8, W4KV8 = (None, None), (8, 8), (4, 8)
F32_CASES = [(arch, FP) for arch in DENSE] + [("starcoder2_3b", W4KV8), ("qwen1_5_32b", W8KV8)]
BF16_CASES = [("starcoder2_3b", W4KV8), ("qwen1_5_32b", FP), ("minitron_4b", W8KV8)]


def _j(a):
    """A JAX array of numpy's array, its dtype kept."""
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


def _numpy_tree(tree):
    """numpy leaves, in the tree's own order of keys; a QWeight as its arrays."""
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


@pytest.fixture(scope="module")
def reference_params():
    """The reference's SMOKE parameters of each dense arch from PRNGKey(0)."""
    with jax.threefry_partitionable(True):
        return {arch: jmodel.init_params(jconfigs.get_smoke_config(arch),
                                         jax.random.PRNGKey(0)) for arch in DENSE}


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S + 2)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_is_the_reference_tree(reference_params, arch):
    pj = _numpy_tree(reference_params[arch])
    pt = init_params(tconfigs.get_smoke_config(arch), prng.PRNGKey(0), device="cpu")
    lj, lt = _paths(pj), _paths(pt)
    assert [p for p, _ in lt] == [p for p, _ in lj]       # keys, nesting and order
    for (path, a), (_, b) in zip(lj, lt):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape, path
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=INIT_TOL, err_msg=str(path))


def _run_reference(cfg, params, tokens, bits):
    """forward, prefill of S tokens and two decode steps, in one jit."""
    policy = JPolicy(weight_bits=bits[0], kv_bits=bits[1])

    def run(p, toks):
        full, _ = jmodel.forward(cfg, p, toks, policy=policy)
        cache = jmodel.init_cache(cfg, B, S + 8, policy)
        lp, cache = jmodel.prefill(cfg, p, toks[:, :S], cache, policy=policy)
        ld0, cache = jmodel.decode_step(cfg, p, toks[:, S], cache, policy=policy)
        ld1, _ = jmodel.decode_step(cfg, p, toks[:, S + 1], cache, policy=policy,
                                    position=jnp.asarray(S + 1, dtype=jnp.int32))
        return full, lp, ld0, ld1

    compiled = jax.jit(run)
    return [np.asarray(a, np.float32) for a in compiled(params, _j(tokens))]


def _run_port(cfg, params, tokens, bits):
    policy = QuantPolicy(weight_bits=bits[0], kv_bits=bits[1])
    toks = torch.from_numpy(tokens)
    full, aux = forward(cfg, params, toks, policy=policy)
    assert float(aux["moe_load_loss"]) == 0.0
    cache = init_cache(cfg, B, S + 8, policy, device="cpu")
    lp, cache = prefill(cfg, params, toks[:, :S], cache, policy=policy)
    ld0, cache = decode_step(cfg, params, toks[:, S], cache, policy=policy)
    assert cache["slots"]["slot0"].length == S + 1
    ld1, cache = decode_step(cfg, params, toks[:, S + 1], cache, policy=policy, position=S + 1)
    return [a.float().numpy() for a in (full, lp, ld0, ld1)]


def _hold(arch, dtype, bits, reference_params, tol):
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype)
    cfg_t = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype)
    pj = reference_params[arch]
    if bits[0]:
        # nearest codes (no key: the order of keys does not matter)
        quantize = jax.jit(lambda p: jq.quantize_params(p, bits[0]))
        pj = quantize(pj)
    pt = lm_params_from_numpy(_numpy_tree(pj), "cpu")
    tokens = _tokens(cfg_t)
    want = _run_reference(cfg_j, pj, tokens, bits)
    got = _run_port(cfg_t, pt, tokens, bits)
    scale = float(np.abs(want[0]).max())
    for name, g, w in zip(("forward", "prefill", "decode", "decode+1"), got, want):
        assert g.shape == w.shape, name
        assert np.isfinite(g).all(), name
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol, f"{name}: max |Δ| / max|logits| = {err:.3g} > {tol}"
    # the serving path against its own teacher-forced logits (the reference's
    # consistency bound, tests/test_models_smoke.py)
    full, lp, ld0, ld1 = got
    for g, w in ((lp, full[:, S - 1]), (ld0, full[:, S]), (ld1, full[:, S + 1])):
        assert float(np.abs(g - w).max()) / scale < BF16_TOL


@pytest.mark.parametrize("arch,bits", F32_CASES)
def test_float32_logits(reference_params, arch, bits):
    _hold(arch, "float32", bits, reference_params, F32_TOL)


@pytest.mark.parametrize("arch,bits", BF16_CASES)
def test_bfloat16_logits(reference_params, arch, bits):
    _hold(arch, "bfloat16", bits, reference_params, BF16_TOL)


def test_generate_is_greedy_over_prefill_and_decode():
    cfg = dataclasses.replace(tconfigs.get_smoke_config("starcoder2_3b"), dtype="float32")
    params = init_params(cfg, prng.PRNGKey(0), device="cpu")
    prompt = torch.from_numpy(_tokens(cfg)[:, :S])
    seen = []
    toks, logits = generate(cfg, params, prompt, 4, QuantPolicy(kv_bits=8),
                            on_step=lambda i, lg: seen.append(i))
    assert toks.shape == (B, 4) and logits.shape == (B, 4, cfg.padded_vocab)
    assert seen == [0, 1, 2, 3]
    assert torch.equal(toks, logits.argmax(-1))
    full, _ = forward(cfg, params, torch.cat([prompt, toks[:, :3]], dim=1))
    scale = float(full.abs().max())
    # KV8 makes the cached path differ from the teacher-forced one by the
    # codes' rounding: the reference's 2e-2 bound
    assert float((logits - full[:, S - 1:]).abs().max()) / scale < 2e-2


@pytest.mark.parametrize("arch", [a for a in jconfigs.ARCH_IDS if a not in DENSE])
def test_unported_families_raise(arch):
    """Only training raises, for the encdec (whisper-tiny) and vlm
    (llama-3.2-vision-11b) families, which serve; the hybrid
    (recurrentgemma-2b) and SSM (mamba2-370m) families serve and train:
    loss_fn gives a finite loss (tests/test_torch_train_recurrent.py holds it
    and its gradients to the reference); so does the MoE family (qwen3-moe),
    which also serves here: a prefill and a decode step give finite logits
    (tests/test_torch_moe.py holds both, loss_fn and its gradients to the
    reference)."""
    cfg = tconfigs.get_smoke_config(arch)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    if cfg.family in ("hybrid", "ssm", "moe"):
        params = init_params(cfg, prng.PRNGKey(0), device="cpu")
        assert bool(torch.isfinite(loss_fn(cfg, params, {"tokens": toks, "labels": toks})))
        if cfg.family == "moe":
            cache = init_cache(cfg, 1, 8, device="cpu")
            logits, cache = prefill(cfg, params, toks, cache)
            step, _ = decode_step(cfg, params, toks[:, 0], cache)
            assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step).all())
        return
    calls = {"loss_fn": lambda: loss_fn(cfg, {}, {"tokens": toks, "labels": toks})}
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=rf"{name}: the {cfg.family} family"):
            call()


def test_entry_points_default_to_the_card():
    """Without a device they run on the GPU, and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = tconfigs.get_smoke_config("starcoder2_3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, prng.PRNGKey(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
