"""Training the cross-attention families on the CPU, against the JAX
reference: whisper-tiny (encdec: ``loss_fn`` encodes the batch's stub frames,
so the encoder trains with the decoder) and llama-3.2-vision-11b (vlm: the
image layers read the batch's image embeddings as they are). ``loss_fn`` and
every gradient leaf (the encoder's included) with per-layer remat on and
off, the Q8 codes of those gradients, the projection's leaves, three
``make_train_step`` steps with Q8 and IHT in one microbatch and in two (the
memory split with the tokens), a killed ``train_loop`` resumed, the
reference's train state carried over, and the launcher's refusal.

The SMOKE configs in float32, B = 2 rows of S = 48 tokens (so that the
cross-attention's Sq differs from the memory's 64 frames or 16 image rows),
and the vlm cut to ``cross_attn_every = 2`` (five layers (xattn, attn) × 2 +
xattn), so that an image layer sits in a stacked slot of two and in the
tail. The weights are the port's init (within 1e-6 of the reference's).

Tolerances (``F32_TOL`` = 1e-5): the loss relative and every gradient leaf
within 1e-5 of its max|g|; three training steps: the loss within 1e-5
relative at each step and the supports of the projected leaves bit for bit;
the Q8 codes of the same gradients with the same key bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.optim import IHTConfig as JIHT
from repro.optim import adamw as jadamw
from repro.optim.adamw import AdamWState as JAdamWState
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
from repro_torch.models import init_params, loss_fn
from repro_torch.optim import IHTConfig, adamw, cosine_schedule, iht, sparsity_report
from repro_torch.parallel.collectives import fake_grad_compression
from repro_torch.quant.policy import QuantPolicy
from repro_torch.train import LoopConfig, checkpoint, init_state, make_train_step
from repro_torch.train import run_with_restarts, train_loop
from repro_torch.train.steps import _microbatches
from repro_torch.tree import keystr, tree_flatten_with_path, tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread

F32_TOL = 1e-5
VLM_CUT = "llama32_vision_11b_every_2"    # the vlm SMOKE config with cross_attn_every = 2
ARCHS = ("whisper_tiny", "llama32_vision_11b", VLM_CUT)
B, S = 2, 48
MIN_SIZE = 2048                  # projects the SMOKE trees' larger matrices


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


def _configs(arch):
    cut = arch == VLM_CUT
    name = "llama32_vision_11b" if cut else arch
    extra = {"cross_attn_every": 2} if cut else {}
    return (dataclasses.replace(jconfigs.get_smoke_config(name), dtype="float32", **extra),
            dataclasses.replace(tconfigs.get_smoke_config(name), dtype="float32", **extra))


def _numpy(tree):
    if hasattr(tree, "_fields"):
        return type(tree)(*(_numpy(v) for v in tree))
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return np.array(tree)


def _j(a):
    """A JAX array of numpy's array, its dtype kept."""
    return jnp.asarray(a, dtype=a.dtype)


def _mem_rows(cfg) -> int:
    return cfg.encoder_seq if cfg.family == "encdec" else cfg.n_image_tokens


class MemoryStream(SyntheticStream):
    """The synthetic stream with a float32 ``memory`` (B, T, d_model) a step,
    drawn from (seed, step) as the tokens are: stub frames or image rows."""

    def __init__(self, seed, batch, seq, cfg, device="cpu"):
        super().__init__(seed, batch, seq, cfg.vocab_size, device=device)
        self.mem_key = prng.fold_in(prng.PRNGKey(seed), 1 << 20)
        self.mem_shape = (batch, _mem_rows(cfg), cfg.d_model)

    def at_step(self, step):
        out = super().at_step(step)
        out["memory"] = prng.normal(prng.fold_in(self.mem_key, step), self.mem_shape,
                                    device="cpu").to(self.device)
        return out


def _batch(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -1
    memory = rng.standard_normal((B, _mem_rows(cfg), cfg.d_model)).astype(np.float32)
    return {"tokens": toks[:, :-1].copy(), "labels": labels, "memory": memory}


def _port_value_and_grad(cfg, params_np, batch):
    params = lm_params_from_numpy(params_np, "cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), [p.grad.numpy() for p in leaves]


@pytest.fixture(scope="module")
def reference_grads():
    """Per arch: the weights (the port's init for PRNGKey(0)), the batch
    (tokens, labels with padding, a float32 memory), and the reference's
    loss and gradients on them (its jax.value_and_grad of loss_fn)."""
    out = {}
    for arch in ARCHS:
        cj, ct = _configs(arch)
        params_np = _numpy(tree_map(lambda t: t.numpy(),
                                    init_params(ct, prng.PRNGKey(0), device="cpu")))
        batch = _batch(cj)
        value_and_grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(cj, p, b)))
        loss, grads = value_and_grad(jax.tree_util.tree_map(_j, params_np),
                                     {k: _j(v) for k, v in batch.items()})
        out[arch] = {"params": params_np, "batch": batch, "loss": float(loss),
                     "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]}
    return out


@pytest.fixture(scope="module")
def port_grads(reference_grads):
    """Per (arch, remat): the port's loss and gradients on the reference's
    inputs, and how many times ``torch.utils.checkpoint.checkpoint`` ran."""
    import torch.utils.checkpoint as ckpt

    real, calls, out = ckpt.checkpoint, [], {}

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    ckpt.checkpoint = counted
    try:
        for arch, ref in reference_grads.items():
            for remat in (True, False):
                ct = dataclasses.replace(_configs(arch)[1], remat=remat)
                calls.clear()
                loss, grads = _port_value_and_grad(ct, ref["params"], ref["batch"])
                out[arch, remat] = {"loss": loss, "grads": grads, "checkpoints": len(calls)}
    finally:
        ckpt.checkpoint = real
    return out


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_float32(reference_grads, port_grads, arch, remat):
    """The loss and every gradient leaf against the reference's, per-layer
    remat on and off: the memory reaches each checkpointed layer through its
    context, and the encoder's leaves (whisper) get the gradient that flows
    back through every cross-attention's K/V."""
    ref, ct = reference_grads[arch], _configs(arch)[1]
    loss, got = port_grads[arch, remat]["loss"], port_grads[arch, remat]["grads"]
    want = ref["grads"]
    assert abs(loss - ref["loss"]) <= F32_TOL * abs(ref["loss"])
    names = [keystr(path) for path, _ in tree_flatten_with_path(ref["params"])]
    assert len(got) == len(want) == len(names)
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and np.isfinite(g).all(), name
        assert float(np.abs(g - w).max()) <= F32_TOL * float(np.abs(w).max()), name
    enc = [np.abs(g).max() for name, g in zip(names, got) if name.startswith("['encoder']")]
    assert (len(enc) > 0 and min(enc) > 0) == (ct.family == "encdec")
    cross = [np.abs(g).max() for name, g in zip(names, got) if "['xattn']['wk']" in name]
    assert cross and min(cross) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_gradients(port_grads, arch):
    """Per-layer checkpointing of the decoder's layers ("xattn" and "attn";
    the encoder keeps its activations, as the reference's ``encode`` scans
    without ``jax.checkpoint``) gives the gradients of the run that keeps
    every activation, bit for bit."""
    remat, kept = port_grads[arch, True], port_grads[arch, False]
    assert remat["checkpoints"] == _configs(arch)[1].n_layers and kept["checkpoints"] == 0
    assert remat["loss"] == kept["loss"]
    for a, b in zip(remat["grads"], kept["grads"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["whisper_tiny", VLM_CUT])
def test_q8_codes_of_the_gradients_bit_for_bit(reference_grads, arch):
    """The reference's gradient tree (the encoder's blocks, or the image
    layers in a stacked slot and in the tail, in its order of leaves)
    through both packages' compression with one key: every dequantized code
    bit for bit."""
    ref = reference_grads[arch]
    grads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(ref["params"]),
                                         ref["grads"])
    key = jax.random.PRNGKey(11)
    compress = jax.jit(lambda g, k: jcompress(g, 8, k))
    with jax.threefry_partitionable(True):
        want = compress(grads, key)
    got = fake_grad_compression(lm_params_from_numpy(grads, "cpu"), 8,
                                key_from_numpy(np.asarray(key)))
    assert len(jax.tree_util.tree_leaves(want)) == len(tree_leaves(got))
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


class _Taken:
    """A leaf the reference's projection handed to its H_s, with its keep."""

    def __init__(self, keep):
        self.keep = keep


@pytest.mark.parametrize("arch", ARCHS)
def test_projection_takes_the_reference_leaves(reference_grads, arch, monkeypatch):
    """The leaves the IHT projection takes, and the entries it keeps of each,
    are the reference's: the ones its project_params hands to its H_s
    (``_project_matrix``, recorded here in place of the threshold), at
    min_size 1 and at the default; the encoder's matrices and the image
    layers' wk, wv among them."""
    import repro.optim.iht as jiht

    params = reference_grads[arch]["params"]
    port = lm_params_from_numpy(params, "cpu")
    monkeypatch.setattr(jiht, "_project_matrix", lambda w, keep: _Taken(keep))
    for min_size in (1, IHTConfig().min_size):
        marked = jproject(params, JIHT(sparsity=0.5, min_size=min_size))
        want = {jax.tree_util.keystr(path): leaf.keep
                for path, leaf in jax.tree_util.tree_flatten_with_path(marked)[0]
                if isinstance(leaf, _Taken)}
        cfg_iht = IHTConfig(sparsity=0.5, min_size=min_size)
        got = {keystr(path): iht.keep_count(leaf, cfg_iht)
               for path, leaf in tree_flatten_with_path(port) if iht.eligible(path, leaf, cfg_iht)}
        assert got == want, min_size
        if min_size == 1:
            assert any("['xattn']['wk']" in p for p in got)
            assert any(p.startswith("['encoder']") for p in got) == (arch == "whisper_tiny")


def _reference_run(cj, params, steps, accum_steps):
    """The reference's jitted make_train_step (Q8 gradients, the projection)
    for ``steps`` steps from ``params`` and AdamW's zero moments, on the
    port's stream, ``batch["memory"]`` included: (the start state as numpy,
    the end state, the losses)."""
    oj = jadamw(jcosine(3e-3, 2, 10))
    with jax.threefry_partitionable(True):
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=params, opt=oj.init(params),
                            rng=jax.random.PRNGKey(0))
        step = jax.jit(jmake_train_step(cj, oj, policy=JPolicy(grad_bits=8),
                                        iht=JIHT(sparsity=0.5, min_size=MIN_SIZE),
                                        accum_steps=accum_steps))
        stream = MemoryStream(0, B, S, cj)
        start = _numpy(state)
        losses = []
        for i in range(steps):
            state, m = step(state, {k: _j(v.numpy()) for k, v in stream.at_step(i).items()})
            losses.append(float(m["loss"]))
    return start, state, losses


@pytest.mark.parametrize("arch,accum_steps", [("whisper_tiny", 2), (VLM_CUT, 1)])
def test_three_train_steps_with_q8_and_iht(reference_grads, arch, accum_steps):
    """Three steps of make_train_step with Q8 gradients and the projection at
    50%, each batch with its memory; whisper-tiny's in two microbatches
    against the reference's scan over them (the memory split along its batch
    axis with the tokens, each microbatch encoded on its own). The start state is the reference's, carried over by
    train_state_from_numpy."""
    cj, ct = _configs(arch)
    params = jax.tree_util.tree_map(_j, reference_grads[arch]["params"])
    start, jstate, want = _reference_run(cj, params, 3, accum_steps)
    state = train_state_from_numpy(start, "cpu")
    cfg_iht = IHTConfig(sparsity=0.5, min_size=MIN_SIZE)
    step = make_train_step(ct, adamw(cosine_schedule(3e-3, 2, 10)),
                           policy=QuantPolicy(grad_bits=8), iht=cfg_iht, accum_steps=accum_steps)
    stream = MemoryStream(0, B, S, ct)
    for i in range(3):
        state, m = step(state, stream.at_step(i))
        assert abs(float(m["loss"]) - want[i]) <= F32_TOL * want[i], i
    assert int(state.step) == 3
    assert sparsity_report(state.params, cfg_iht) == jsparsity(
        jstate.params, JIHT(min_size=MIN_SIZE)) == 0.5
    projected = []
    for (path, got), want_leaf in zip(tree_flatten_with_path(state.params),
                                      jax.tree_util.tree_leaves(jstate.params)):
        if iht.eligible(path, got, cfg_iht):
            np.testing.assert_array_equal(got.numpy() != 0, np.asarray(want_leaf) != 0,
                                          err_msg=keystr(path))
            projected.append(keystr(path))
    assert any("xattn" in p for p in projected)
    assert any(p.startswith("['encoder']") for p in projected) == (ct.family == "encdec")


def test_train_state_from_numpy_carries_the_encoder(reference_grads):
    """A reference whisper-tiny train state (its TrainState and AdamWState;
    the weights, and moments drawn from a seed) as the port's: the encoder's
    stacked blocks and final norm in the parameters and in both moments,
    every leaf equal, in the reference's order of leaves."""
    params = reference_grads["whisper_tiny"]["params"]
    rng = np.random.default_rng(3)
    mu, nu = (jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(a.dtype),
                                     params) for _ in range(2))
    opt = JAdamWState(step=np.int32(5), mu=mu, nu=nu)
    state = JTrainState(step=np.int32(5), params=params, opt=opt,
                        rng=np.asarray(jax.random.PRNGKey(0)))
    got = train_state_from_numpy(state, "cpu")
    assert int(got.step) == 5 and int(got.opt.step) == 5
    for mine, theirs in ((got.params, params), (got.opt.mu, mu), (got.opt.nu, nu)):
        assert list(mine["encoder"]) == ["blocks", "final_norm"]
        assert mine["encoder"]["blocks"]["attn"]["wq"]["w"].shape[0] == 2
        want = jax.tree_util.tree_flatten_with_path(theirs)[0]
        have = tree_flatten_with_path(mine)
        assert [keystr(p) for p, _ in have] == [jax.tree_util.keystr(p) for p, _ in want]
        for (path, a), (_, b) in zip(have, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=keystr(path))


def test_microbatches_split_the_memory_with_the_tokens():
    """Two microbatches of a batch of four rows: the tokens, the labels and
    the memory each in row halves, the memory's (T, d) kept."""
    cfg = _configs("whisper_tiny")[1]
    batch = MemoryStream(0, 4, 8, cfg).at_step(0)
    parts = _microbatches(batch, 2)
    for i, part in enumerate(parts):
        assert set(part) == {"tokens", "labels", "memory"}
        for k, v in part.items():
            assert v.shape == (2,) + tuple(batch[k].shape[1:])
            assert torch.equal(v, batch[k][2 * i:2 * i + 2]), k


def test_train_loop_resumes_bit_for_bit(tmp_path):
    """whisper-tiny killed after 2 steps (a checkpoint after each) and
    restarted: the final state (the encoder's tree, the cross-attention's
    leaves and AdamW's moments) equals an uninterrupted 3-step run bit for
    bit, Q8 gradients and the projection on, the stream replaying each
    step's memory; the checkpoint's manifest names the encoder's and the
    cross-attention's leaves, and a restore of it is the same state."""
    _, cfg = _configs("whisper_tiny")
    opt = adamw(3e-3)
    step = make_train_step(cfg, opt, policy=QuantPolicy(grad_bits=8),
                           iht=IHTConfig(sparsity=0.5, min_size=MIN_SIZE))
    stream = MemoryStream(0, 2, 32, cfg)

    def fresh():        # the step works in place: every run starts from its own state
        return init_state(cfg, opt, prng.PRNGKey(0), device="cpu")

    def loop_cfg(total, d):
        return LoopConfig(total_steps=total, ckpt_dir=str(d), ckpt_every=1, ckpt_async=False,
                          log_every=100)

    want = train_loop(step, fresh(), stream, loop_cfg(3, tmp_path / "whole"), log=lambda s: None)
    logs = []

    def body(attempt):
        if attempt == 0:
            train_loop(step, fresh(), stream, loop_cfg(2, tmp_path / "crashy"),
                       log=lambda s: None)
            raise RuntimeError("injected node failure")
        return train_loop(step, fresh(), stream, loop_cfg(3, tmp_path / "crashy"),
                          log=logs.append)

    got = run_with_restarts(body, max_restarts=1)
    assert logs == ["[loop] resumed from checkpoint step 2"] and int(got.step) == 3
    for a, b in zip(tree_leaves(want), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    manifest = (tmp_path / "crashy" / f"step_{3:08d}" / "manifest.json").read_text()
    assert "['xattn']" in manifest and "['encoder']" in manifest
    restored = checkpoint.restore(str(tmp_path / "crashy"), 3, fresh())
    for a, b in zip(tree_leaves(want), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["whisper_tiny", "llama32_vision_11b"])
def test_launcher_exits_2_for_the_cross_families(arch, capsys):
    """The launcher's stream carries no memory (the reference's passes
    memory=None), so for the cross families it exits 2 with a message that
    names the missing memory, not a traceback."""
    with pytest.raises(SystemExit) as e:
        train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    family = "encdec" if arch == "whisper_tiny" else "vlm"
    assert f"the {family} family" in err and "memory" in err and "Traceback" not in err
