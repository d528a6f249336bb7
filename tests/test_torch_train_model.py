"""Training the dense LM on the CPU, against the JAX reference: ``loss_fn``
and its gradients, the attention backward the card runs, three
``make_train_step`` steps with Q8 gradients and the IHT projection,
gradient accumulation, a killed ``train_loop`` resumed, and the CLI.

Tolerances:
* float32 (``dtype="float32"``): the loss and every gradient leaf within
  1e-5 of the reference's (relative to the loss, and to the leaf's max|g|);
  the two packages differ only in the order of float32 sums (measured ≤ 8.2e-7).
* bfloat16 (the SMOKE config as published): each gradient leaf, and the
  loss, within twice the reference's own bfloat16 error on it, that is
  2·max|g_bf16 − g_f32| of the reference on the same weights and tokens.
  Both packages round to bfloat16 at the same ops but sum in other orders,
  so each sits about that far from the float32 gradient and at most twice
  that from the other (measured: port vs reference ≤ 0.019·max|g|, the
  reference's own error ≤ 0.028·max|g|).
* the attention backward (float32): within 1e-5·max|grad| of the
  reference's custom VJP.
* three training steps (float32, Q8, IHT 50%): the loss within 1e-5
  relative at each step (a Q8 code whose uniform sits on its rounding edge
  can flip between the packages; measured ≤ 3.2e-7), the sparsity exactly
  the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticStream as JStream
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import IHTConfig as JIHT
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.optim import sparsity_report as jsparsity
from repro.quant.policy import QuantPolicy as JPolicy
from repro.train import init_state as jinit_state
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import random as prng
from repro_torch.convert import lm_params_from_numpy, train_state_from_numpy
from repro_torch.data import SyntheticStream
from repro_torch.launch import train as train_cli
from repro_torch.models import layers, loss_fn
from repro_torch.optim import IHTConfig, adamw, cosine_schedule, sparsity_report
from repro_torch.quant.policy import QuantPolicy
from repro_torch.train import (
    LoopConfig,
    TrainState,
    init_state,
    make_train_step,
    run_with_restarts,
    train_loop,
)
from repro_torch.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread

F32_TOL = 1e-5
ARCH = "starcoder2_3b"


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


def _numpy(tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return np.array(tree)


def _configs(dtype):
    return (dataclasses.replace(jconfigs.get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke_config(ARCH), dtype=dtype))


def _batch(vocab, b=4, s=128):
    """Tokens of two attention chunks (the SMOKE chunk is 64) and labels
    with padding."""
    toks = np.random.default_rng(0).integers(0, vocab, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    return toks[:, :-1].copy(), labels


def _j(a):
    """A JAX array of numpy's array, its dtype kept."""
    return jnp.asarray(a, dtype=a.dtype)


def _reference_value_and_grad(cfg, params, tokens, labels):
    batch = {"tokens": _j(tokens), "labels": _j(labels)}
    value_and_grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(cfg, p, b)))
    loss, grads = value_and_grad(params, batch)
    return float(loss), [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(grads)]


def _port_value_and_grad(cfg, params_np, tokens, labels):
    params = lm_params_from_numpy(params_np, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens),
                                 "labels": torch.from_numpy(labels)})
    loss.backward()
    return float(loss.detach()), [p.grad.float().numpy() for p in leaves]


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's loss and gradients at float32 and bfloat16 on the
    same weights (the float32 init) and tokens."""
    cj, _ = _configs("float32")
    with jax.threefry_partitionable(True):
        params = jmodel.init_params(cj, jax.random.PRNGKey(0))
    tokens, labels = _batch(cj.vocab_size)
    out = {"params": _numpy(params), "tokens": tokens, "labels": labels}
    for dtype in ("float32", "bfloat16"):
        out[dtype] = _reference_value_and_grad(_configs(dtype)[0], params, tokens, labels)
    return out


def test_loss_and_grads_float32(reference_grads):
    _, ct = _configs("float32")
    want_loss, want = reference_grads["float32"]
    loss, got = _port_value_and_grad(ct, reference_grads["params"], reference_grads["tokens"],
                                     reference_grads["labels"])
    assert abs(loss - want_loss) <= F32_TOL * abs(want_loss)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= F32_TOL * float(np.abs(w).max()), i


def test_loss_and_grads_bfloat16(reference_grads):
    _, ct = _configs("bfloat16")
    want_loss, want = reference_grads["bfloat16"]
    f32_loss, f32 = reference_grads["float32"]
    loss, got = _port_value_and_grad(ct, reference_grads["params"], reference_grads["tokens"],
                                     reference_grads["labels"])
    assert abs(loss - want_loss) <= max(2 * abs(want_loss - f32_loss), F32_TOL * abs(want_loss))
    for i, (g, w, w32) in enumerate(zip(got, want, f32)):
        own = float(np.abs(w - w32).max())
        assert float(np.abs(g - w).max()) <= 2 * own, i


@pytest.mark.parametrize("causal", [True, False])
def test_attention_backward_matches_the_reference_vjp(causal):
    """The card's backward route, run here on the CPU: GQA (4 query heads on
    2), three chunks each way, against jax.vjp of the reference's
    chunked_attention (its flash-style custom VJP) and against autograd
    through the plain forward."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 4, 96, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 96, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 96, 16)).astype(np.float32)
    g = rng.standard_normal((2, 4, 96, 16)).astype(np.float32)

    def ref(q, k, v):
        return jlayers.chunked_attention(q, k, v, causal=causal, chunk=32)

    _, vjp = jax.vjp(ref, _j(q), _j(k), _j(v))
    want = [np.asarray(a) for a in vjp(_j(g))]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = layers.chunked_attention_plain(qt, kt, vt, causal=causal, chunk=32)
    got = layers.attention_backward_plain(qt.detach(), kt.detach(), vt.detach(), out.detach(),
                                          torch.from_numpy(g), causal=causal, chunk=32)
    out.backward(torch.from_numpy(g))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, (qt.grad, kt.grad, vt.grad)):
        scale = float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) <= F32_TOL * scale, name
        assert float((a - c).abs().max()) <= F32_TOL * scale, name


def _reference_run(cj, ot_args, steps, b, s, accum_steps=1, with_ops=True):
    oj = jadamw(jcosine(*ot_args))
    with jax.threefry_partitionable(True):
        state = jinit_state(cj, oj, jax.random.PRNGKey(0))
        policy = JPolicy(grad_bits=8) if with_ops else JPolicy()
        iht = JIHT(sparsity=0.5, min_size=2048) if with_ops else None
        step = jax.jit(jmake_train_step(cj, oj, policy=policy, iht=iht, accum_steps=accum_steps))
        stream = JStream(0, b, s, cj.vocab_size)
        start = _numpy(state)
        losses, tokens = [], []
        for i in range(steps):
            batch = dict(stream.at_step(i))
            tokens.append(np.asarray(batch["tokens"]))
            batch["memory"] = None
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return start, state, losses, tokens


def test_three_train_steps_with_q8_and_iht():
    cj, ct = _configs("float32")
    start, jstate, want, jtokens = _reference_run(cj, (3e-3, 2, 10), 3, 4, 64)
    state = train_state_from_numpy(start, "cpu")
    assert isinstance(state, TrainState) and int(state.step) == 0
    step = make_train_step(ct, adamw(cosine_schedule(3e-3, 2, 10)),
                           policy=QuantPolicy(grad_bits=8),
                           iht=IHTConfig(sparsity=0.5, min_size=2048))
    stream = SyntheticStream(0, 4, 64, ct.vocab_size, device="cpu")
    for i in range(3):
        batch = stream.at_step(i)
        np.testing.assert_array_equal(batch["tokens"].numpy(), jtokens[i])
        state, m = step(state, batch)
        assert abs(float(m["loss"]) - want[i]) <= F32_TOL * want[i], i
    assert int(state.step) == 3 and int(state.opt.step) == 3
    assert sparsity_report(state.params, IHTConfig(min_size=2048)) == jsparsity(
        jstate.params, JIHT(min_size=2048)) == 0.5
    assert all(not p.requires_grad and p.grad is None for p in tree_leaves(state.params))


def test_gradient_accumulation_matches_the_reference():
    """Two microbatches: the loss, and AdamW's first moment (linear in the
    gradient; the first step's parameters are not, sign(g)·lr where |g| is
    near eps), within 1e-5 of the reference's scan."""
    cj, ct = _configs("float32")
    start, jstate, want, _ = _reference_run(cj, (3e-3, 2, 10), 1, 4, 32, accum_steps=2,
                                            with_ops=False)
    state = train_state_from_numpy(start, "cpu")
    step = make_train_step(ct, adamw(cosine_schedule(3e-3, 2, 10)), accum_steps=2)
    state, m = step(state, SyntheticStream(0, 4, 32, ct.vocab_size, device="cpu").at_step(0))
    assert abs(float(m["loss"]) - want[0]) <= F32_TOL * want[0]
    for a, b in zip(jax.tree_util.tree_leaves(jstate.opt.mu), tree_leaves(state.opt.mu)):
        a = np.asarray(a)
        assert float(np.abs(b.numpy() - a).max()) <= F32_TOL * float(np.abs(a).max())


def test_train_loop_resumes_bit_for_bit(tmp_path):
    """Killed after 6 steps (checkpoints every 4), restarted: the final state
    equals an uninterrupted 12-step run bit for bit (the reference's
    tests/test_runtime.py contract), with Q8 gradients and the projection."""
    cfg = tconfigs.get_smoke_config(ARCH)
    opt = adamw(3e-3)
    step = make_train_step(cfg, opt, policy=QuantPolicy(grad_bits=8),
                           iht=IHTConfig(sparsity=0.5, min_size=2048))
    stream = SyntheticStream(0, 8, 32, cfg.vocab_size, device="cpu")

    def fresh():        # the step works in place: every run starts from its own state
        return init_state(cfg, opt, prng.PRNGKey(0), device="cpu")

    def loop_cfg(total, d):
        return LoopConfig(total_steps=total, ckpt_dir=str(d), ckpt_every=4, ckpt_async=False,
                          log_every=100)

    want = train_loop(step, fresh(), stream, loop_cfg(12, tmp_path / "whole"), log=lambda s: None)
    calls, logs = {"n": 0}, []

    def body(attempt):
        calls["n"] += 1
        if attempt == 0:
            train_loop(step, fresh(), stream, loop_cfg(6, tmp_path / "crashy"),
                       log=lambda s: None)
            raise RuntimeError("injected node failure")
        return train_loop(step, fresh(), stream, loop_cfg(12, tmp_path / "crashy"),
                          log=logs.append)

    got = run_with_restarts(body, max_restarts=2)
    assert calls["n"] == 2 and logs == ["[loop] resumed from checkpoint step 4"]
    assert int(got.step) == int(want.step) == 12
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert torch.equal(a, b)


def test_train_cli_smoke_on_cpu(capsys):
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                    "--batch", "4", "--seq", "32", "--grad-bits", "8", "--iht-sparsity", "0.5"])
    out = capsys.readouterr().out
    assert "[loop] step=0 loss=" in out and "[train] done at step 3" in out


def test_train_cli_refuses_a_mesh_and_defaults_to_the_card(capsys):
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2x4"])
    assert e.value.code == 2
    assert "ROADMAP.md queue 1's sharding item" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(["--arch", ARCH, "--smoke", "--steps", "1"])


def test_train_lm_sparse_example_on_cpu(capsys):
    """The twin of examples/train_lm_sparse.py: every eligible matrix at 50%
    zeros after each step."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "train_lm_sparse_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_sparse_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step    1" in out and "weight_zeros=50.0%" in out


def test_remat_recomputes_the_same_gradients(reference_grads, monkeypatch):
    """Per-layer checkpointing (cfg.remat, as the reference's jax.checkpoint)
    runs each layer's forward again in the backward and gives the gradients
    of the run that keeps every activation, bit for bit; a forward that
    records no gradient checkpoints nothing."""
    import torch.utils.checkpoint as ckpt

    _, ct = _configs("float32")
    calls = []
    real = ckpt.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", counted)
    args = (reference_grads["params"], reference_grads["tokens"], reference_grads["labels"])
    loss_a, remat = _port_value_and_grad(ct, *args)
    assert len(calls) == ct.n_layers
    loss_b, kept = _port_value_and_grad(dataclasses.replace(ct, remat=False), *args)
    assert len(calls) == ct.n_layers and loss_a == loss_b
    for a, b in zip(remat, kept):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        loss_fn(ct, lm_params_from_numpy(reference_grads["params"], "cpu"),
                {"tokens": torch.from_numpy(args[1]), "labels": torch.from_numpy(args[2])})
    assert len(calls) == ct.n_layers
