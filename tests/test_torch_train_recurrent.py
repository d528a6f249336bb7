"""Training the recurrent families on the CPU, against the JAX reference:
recurrentgemma-2b (hybrid: RG-LRU blocks and windowed attention) and
mamba2-370m (ssm: the chunked SSD). The attention backward with a window
and a query offset, ``loss_fn`` and its gradients, the Q8 codes of those
gradients, the projection's leaves, three ``make_train_step`` steps with Q8
and IHT, gradient accumulation, per-layer remat, a killed ``train_loop``
resumed, and the CLI.

Both SMOKE configs in float32 at S = 64: the hybrid's window of 32 bites
(its attention chunk is 32), and 64 is four of the ssm's 16-token chunks.

Tolerances (``F32_TOL`` = 1e-5):
* the attention backward: within 1e-5·max|grad| of ``jax.vjp`` of the
  reference's ``chunked_attention`` (its flash-style custom VJP);
* the loss relative, and every gradient leaf within 1e-5 of its max|g|, or
  within twice the reference's own float32 order noise on the leaf where
  that is larger: the port's log-depth RG-LRU scan sums in another order
  than the reference's ``associative_scan``, and the SSD's einsums are
  two-operand contractions. The noise is the reference's batch gradient
  against its per-row gradients recombined (the same sums in another
  order). Only the SSD's ``a_log`` needs it: its gradient (max 3.1e-8) is a
  sum of terms that cancel, and the reference's own noise on it is 2.5e-5 of
  its max (the port's gap 1.85e-5); every other leaf's noise is ≤ 3.3e-6;
* three training steps: the loss within 1e-5 relative at each step, the
  supports of the projected leaves bit for bit; the Q8 codes of the same
  gradients with the same key bit for bit;
* accumulation: the loss and AdamW's first moment within 1e-5 of the
  reference's per-microbatch gradients (or twice its noise, as above), and
  three steps in microbatches against the reference's scan.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.optim import IHTConfig as JIHT
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.optim import project_params as jproject
from repro.optim import sparsity_report as jsparsity
from repro.parallel.collectives import fake_grad_compression as jcompress
from repro.quant.policy import QuantPolicy as JPolicy
from repro.train import TrainState as JTrainState
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import random as prng
from repro_torch.convert import key_from_numpy, lm_params_from_numpy, train_state_from_numpy
from repro_torch.data import SyntheticStream
from repro_torch.launch import train as train_cli
from repro_torch.models import init_params, layers, loss_fn
from repro_torch.optim import IHTConfig, adamw, cosine_schedule, iht, sparsity_report
from repro_torch.parallel.collectives import fake_grad_compression
from repro_torch.quant.policy import QuantPolicy
from repro_torch.train import checkpoint
from repro_torch.train import (
    LoopConfig,
    init_state,
    make_train_step,
    run_with_restarts,
    train_loop,
)
from repro_torch.tree import keystr, tree_flatten_with_path, tree_leaves, tree_map

F32_TOL = 1e-5
ARCHS = ("recurrentgemma_2b", "mamba2_370m")
B, S = 2, 64
MIN_SIZE = 2048                  # projects the SMOKE trees' larger matrices


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


def _configs(arch):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype="float32"),
            dataclasses.replace(tconfigs.get_smoke_config(arch), dtype="float32"))


def _j(a):
    """A JAX array of numpy's array, its dtype kept."""
    return jnp.asarray(a, dtype=a.dtype)


def _batch(vocab):
    toks = np.random.default_rng(0).integers(0, vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    return toks[:, :-1].copy(), labels


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
    """Per arch: the weights (the port's init for PRNGKey(0), within 1e-6 of
    the reference's), tokens, the reference's loss and gradients (float32,
    its jax.value_and_grad of loss_fn) on them, and per leaf its own
    float32 order noise: max|g − ĝ|, ĝ its per-row gradients (each row
    repeated to the batch's shape) weighted by their rows' label counts and
    summed in float64."""
    out = {}
    for arch in ARCHS:
        cj, ct = _configs(arch)
        params_np = _numpy(tree_map(lambda t: t.numpy(),
                                    init_params(ct, prng.PRNGKey(0), device="cpu")))
        params = jax.tree_util.tree_map(_j, params_np)
        tokens, labels = _batch(cj.vocab_size)
        value_and_grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(cj, p, b)))
        loss, grads = value_and_grad(params, {"tokens": _j(tokens), "labels": _j(labels)})
        grads = [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
        counts = (labels >= 0).sum(axis=1)
        rows, row_losses = [], []
        for r in range(B):        # row r twice: its own gradient, at the batch's shape
            l_r, g_r = value_and_grad(params, {"tokens": _j(tokens[[r] * B]),
                                               "labels": _j(labels[[r] * B])})
            rows.append([np.asarray(g, np.float64) for g in jax.tree_util.tree_leaves(g_r)])
            row_losses.append(float(l_r))
        mix = [sum(g[i] * (counts[r] / counts.sum()) for r, g in enumerate(rows))
               for i in range(len(grads))]
        out[arch] = {"params": params_np, "tokens": tokens, "labels": labels,
                     "loss": float(loss), "grads": grads, "rows": rows, "row_losses": row_losses,
                     "own": [float(np.abs(g - w).max()) for g, w in zip(grads, mix)]}
    return out


@pytest.mark.parametrize("window,q_offset", [(24, 0), (None, 40), (24, 40)])
def test_attention_backward_with_a_window_and_an_offset(window, q_offset):
    """The card's backward route, run here on the CPU, with the reference's
    window and query offset: GQA (4 query heads on 2), Sq ≠ Sk where there
    is an offset (queries at 40 … 95 over 96 keys), chunks of 32 keys,
    against jax.vjp of the reference's chunked_attention and autograd through
    the plain forward."""
    rng = np.random.default_rng(2)
    sk = 96
    sq = sk - q_offset
    q = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, sk, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, sk, 16)).astype(np.float32)
    g = rng.standard_normal((2, 4, sq, 16)).astype(np.float32)
    kw = dict(causal=True, chunk=32, window=window, q_offset=q_offset)

    def vjp(q, k, v, g):
        return jax.vjp(lambda q, k, v: jlayers.chunked_attention(q, k, v, **kw), q, k, v)[1](g)

    reference_vjp = jax.jit(vjp)
    want = [np.asarray(a) for a in reference_vjp(_j(q), _j(k), _j(v), _j(g))]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = layers.chunked_attention_plain(qt, kt, vt, **kw)
    got = layers.attention_backward_plain(qt.detach(), kt.detach(), vt.detach(), out.detach(),
                                          torch.from_numpy(g), **kw)
    out.backward(torch.from_numpy(g))
    for name, a, b, c in zip(("dq", "dk", "dv"), got, want, (qt.grad, kt.grad, vt.grad)):
        scale = float(np.abs(b).max())
        assert float(np.abs(a.numpy() - b).max()) <= F32_TOL * scale, name
        assert float((a - c).abs().max()) <= F32_TOL * scale, name


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_float32(reference_grads, arch):
    ref = reference_grads[arch]
    _, ct = _configs(arch)
    loss, got = _port_value_and_grad(ct, ref["params"], ref["tokens"], ref["labels"])
    want = ref["grads"]
    assert abs(loss - ref["loss"]) <= F32_TOL * abs(ref["loss"])
    assert len(got) == len(want)
    for i, (g, w, own) in enumerate(zip(got, want, ref["own"])):
        assert g.shape == w.shape and np.isfinite(g).all(), i
        assert float(np.abs(g - w).max()) <= max(F32_TOL * float(np.abs(w).max()), 2 * own), i


@pytest.mark.parametrize("arch", ARCHS)
def test_q8_codes_of_the_gradients_bit_for_bit(reference_grads, arch):
    """The reference's gradient tree of the family (lambda_raw, conv_w,
    a_log, dt_bias, d_skip, … in its order of leaves) through both packages'
    compression with one key: every dequantized code bit for bit."""
    ref = reference_grads[arch]
    treedef = jax.tree_util.tree_structure(ref["params"])
    grads = jax.tree_util.tree_unflatten(treedef, ref["grads"])
    key = jax.random.PRNGKey(11)
    with jax.threefry_partitionable(True):
        compress = jax.jit(lambda g, k: jcompress(g, 8, k))
        want = compress(grads, key)
    got = fake_grad_compression(lm_params_from_numpy(grads, "cpu"), 8,
                                key_from_numpy(np.asarray(key)))
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_projection_takes_the_reference_leaves(reference_grads, arch):
    """The leaves the IHT projection takes are the reference's: the ones its
    project_params changes at min_size 1 (so that only the predicate's name
    and ndim decide), and of those the ones of 4,096 entries or more at the
    default; the RG-LRU's and the SSD's conv_w (2-D, keyed conv_w) in
    neither."""
    params = reference_grads[arch]["params"]
    port = lm_params_from_numpy(params, "cpu")
    project = jax.jit(lambda p: jproject(p, JIHT(sparsity=0.5, min_size=1)))
    projected = project(params)
    want = {jax.tree_util.keystr(path): leaf.size
            for (path, leaf), old in zip(jax.tree_util.tree_flatten_with_path(projected)[0],
                                         jax.tree_util.tree_leaves(params))
            if not np.array_equal(np.asarray(leaf), old)}
    for min_size in (1, IHTConfig().min_size):
        got = {keystr(path) for path, leaf in tree_flatten_with_path(port)
               if iht.eligible(path, leaf, IHTConfig(min_size=min_size))}
        assert got == {k for k, n in want.items() if n >= min_size}, min_size
        assert got and not any("conv_w" in p for p in got), min_size


def _reference_run(cj, params, ot_args, steps, b, s, accum_steps=1):
    """The reference's make_train_step (Q8 gradients, the projection) for
    ``steps`` steps from ``params`` and AdamW's zero moments, on the port's
    stream: (the start state as numpy, the end state, the
    losses)."""
    oj = jadamw(jcosine(*ot_args))
    key = jax.random.PRNGKey(0)
    with jax.threefry_partitionable(True):
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt=oj.init(params),
                            rng=key)
        step = jax.jit(jmake_train_step(cj, oj, policy=JPolicy(grad_bits=8),
                                        iht=JIHT(sparsity=0.5, min_size=MIN_SIZE),
                                        accum_steps=accum_steps))
        stream = SyntheticStream(0, b, s, cj.vocab_size, device="cpu")
        start = _numpy(state)
        losses = []
        for i in range(steps):      # the port's tokens: the reference's bit for bit
            batch = {k: _j(v.numpy()) for k, v in stream.at_step(i).items()}
            batch["memory"] = None
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
    return start, state, losses


@pytest.mark.parametrize("arch,accum_steps", [("recurrentgemma_2b", 1), ("mamba2_370m", 2)])
def test_three_train_steps_with_q8_and_iht(reference_grads, arch, accum_steps):
    """Three steps of make_train_step, Q8 gradients and the projection at
    50%; the ssm's in two microbatches, against the reference's scan over
    them."""
    cj, ct = _configs(arch)
    params = jax.tree_util.tree_map(_j, reference_grads[arch]["params"])
    start, jstate, want = _reference_run(cj, params, (3e-3, 2, 10), 3, B, S,
                                         accum_steps=accum_steps)
    state = train_state_from_numpy(start, "cpu")
    cfg_iht = IHTConfig(sparsity=0.5, min_size=MIN_SIZE)
    step = make_train_step(ct, adamw(cosine_schedule(3e-3, 2, 10)),
                           policy=QuantPolicy(grad_bits=8), iht=cfg_iht, accum_steps=accum_steps)
    stream = SyntheticStream(0, B, S, ct.vocab_size, device="cpu")
    for i in range(3):
        state, m = step(state, stream.at_step(i))
        assert abs(float(m["loss"]) - want[i]) <= F32_TOL * want[i], i
    assert int(state.step) == 3
    assert sparsity_report(state.params, cfg_iht) == jsparsity(
        jstate.params, JIHT(min_size=MIN_SIZE)) == 0.5
    projected = 0
    for (path, got), want_leaf in zip(tree_flatten_with_path(state.params),
                                      jax.tree_util.tree_leaves(jstate.params)):
        if iht.eligible(path, got, cfg_iht):
            np.testing.assert_array_equal(got.numpy() != 0, np.asarray(want_leaf) != 0,
                                          err_msg=keystr(path))
            projected += 1
    assert projected


@pytest.mark.parametrize("arch", ARCHS)
def test_gradient_accumulation_matches_the_reference(reference_grads, arch):
    """One step over the batch's two rows as two microbatches: the loss the
    mean of the reference's per-row losses, and AdamW's first moment (linear
    in the gradient: 0.1 × the clipped mean of the reference's per-row
    gradients) within 1e-5, or twice the reference's own noise, as the
    gradients are held."""
    ref = reference_grads[arch]
    _, ct = _configs(arch)
    state = init_state(ct, adamw(3e-3), prng.PRNGKey(0), device="cpu")
    state = state._replace(params=lm_params_from_numpy(ref["params"], "cpu"))
    state = state._replace(opt=adamw(3e-3).init(state.params))
    step = make_train_step(ct, adamw(3e-3), accum_steps=2)
    state, m = step(state, {"tokens": torch.from_numpy(ref["tokens"]),
                            "labels": torch.from_numpy(ref["labels"])})
    want_loss = sum(ref["row_losses"]) / B
    assert abs(float(m["loss"]) - want_loss) <= F32_TOL * want_loss
    mean = [sum(g[i] for g in ref["rows"]) / B for i in range(len(ref["grads"]))]
    norm = np.sqrt(sum(float((g * g).sum()) for g in mean))
    clip = min(1.0, 1.0 / max(norm, 1e-9))
    for i, (got, g, own) in enumerate(zip(tree_leaves(state.opt.mu), mean, ref["own"])):
        want = 0.1 * clip * g
        tol = max(F32_TOL * float(np.abs(want).max()), 2 * 0.1 * clip * own)
        assert float(np.abs(got.numpy() - want).max()) <= tol, i


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_gradients(reference_grads, arch, monkeypatch):
    """Per-layer checkpointing of the "rec", "attn" and "ssm" blocks runs
    each layer's forward again in the backward and gives the gradients of
    the run that keeps every activation, bit for bit."""
    import torch.utils.checkpoint as ckpt

    _, ct = _configs(arch)
    ref = reference_grads[arch]
    calls = []
    real = ckpt.checkpoint

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", counted)
    args = (ref["params"], ref["tokens"], ref["labels"])
    loss_a, remat = _port_value_and_grad(ct, *args)
    assert len(calls) == ct.n_layers
    loss_b, kept = _port_value_and_grad(dataclasses.replace(ct, remat=False), *args)
    assert len(calls) == ct.n_layers and loss_a == loss_b
    for a, b in zip(remat, kept):
        np.testing.assert_array_equal(a, b)


def test_train_loop_resumes_bit_for_bit(tmp_path):
    """recurrentgemma-2b killed after 3 steps (checkpoints every 2),
    restarted: the final state (the whole tree, lambda_raw and conv_w among
    it, and AdamW's moments) equals an uninterrupted 6-step run bit for
    bit, with Q8 gradients and the projection."""
    cfg = tconfigs.get_smoke_config("recurrentgemma_2b")
    opt = adamw(3e-3)
    step = make_train_step(cfg, opt, policy=QuantPolicy(grad_bits=8),
                           iht=IHTConfig(sparsity=0.5, min_size=MIN_SIZE))
    stream = SyntheticStream(0, 2, 32, cfg.vocab_size, device="cpu")

    def fresh():        # the step works in place: every run starts from its own state
        return init_state(cfg, opt, prng.PRNGKey(0), device="cpu")

    def loop_cfg(total, d):
        return LoopConfig(total_steps=total, ckpt_dir=str(d), ckpt_every=2, ckpt_async=False,
                          log_every=100)

    want = train_loop(step, fresh(), stream, loop_cfg(6, tmp_path / "whole"), log=lambda s: None)
    logs = []

    def body(attempt):
        if attempt == 0:
            train_loop(step, fresh(), stream, loop_cfg(3, tmp_path / "crashy"),
                       log=lambda s: None)
            raise RuntimeError("injected node failure")
        return train_loop(step, fresh(), stream, loop_cfg(6, tmp_path / "crashy"),
                          log=logs.append)

    got = run_with_restarts(body, max_restarts=1)
    assert logs == ["[loop] resumed from checkpoint step 2"] and int(got.step) == 6
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_round_trips_the_ssm_state(tmp_path):
    """mamba2-370m's train state after two steps (a_log, dt_bias, d_skip,
    conv_w, norm_scale, … and AdamW's moments) saved and restored into a
    fresh state: every leaf bit for bit, the manifest naming its paths."""
    cfg = tconfigs.get_smoke_config("mamba2_370m")
    opt = adamw(3e-3)
    step = make_train_step(cfg, opt, policy=QuantPolicy(grad_bits=8),
                           iht=IHTConfig(sparsity=0.5, min_size=MIN_SIZE))
    state = init_state(cfg, opt, prng.PRNGKey(0), device="cpu")
    stream = SyntheticStream(0, 2, 32, cfg.vocab_size, device="cpu")
    for i in range(2):
        state, _ = step(state, stream.at_step(i))
    checkpoint.save(str(tmp_path), 2, state)
    manifest = (tmp_path / "step_00000002" / "manifest.json").read_text()
    assert all(k in manifest for k in ("a_log", "dt_bias", "d_skip", "conv_w"))
    got = checkpoint.restore(str(tmp_path), 2, init_state(cfg, opt, prng.PRNGKey(1), device="cpu"))
    for a, b in zip(tree_leaves(state), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-370m"])
def test_train_cli_smoke_on_cpu(capsys, arch):
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "64", "--grad-bits", "8", "--iht-sparsity", "0.5"])
    out = capsys.readouterr().out
    assert "[loop] step=0 loss=" in out and "[train] done at step 2" in out
