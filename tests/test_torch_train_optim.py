"""The training side's operators and data on the CPU, against the JAX
reference: ``adamw`` and ``cosine_schedule`` (within 1e-6 relative: the
port writes the same float32 operations in the same order, and only the
global norm's sum runs in another order), ``synthetic_batch``'s tokens,
``fake_grad_compression``'s dequantized gradients and ``project_params``'s
supports, all bit for bit, on the same inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import synthetic_batch as jbatch
from repro.models import model as jmodel
from repro.optim import IHTConfig as JIHT
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.optim import project_params as jproject
from repro.optim import sparsity_report as jsparsity
from repro.optim.iht import _project_matrix as jproject_matrix
from repro.parallel.collectives import fake_grad_compression as jcompress
from repro_torch import configs as tconfigs
from repro_torch import random as prng
from repro_torch.convert import key_from_numpy, lm_params_from_numpy
from repro_torch.data import SyntheticStream, synthetic_batch
from repro_torch.models import init_params
from repro_torch.optim import IHTConfig, adamw, cosine_schedule, project_params, sparsity_report
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.iht import eligible, keep_count, project_matrix_
from repro_torch.parallel import collectives
from repro_torch.parallel.collectives import fake_grad_compression
from repro_torch.tree import keystr, tree_flatten_with_path, tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread

ADAMW_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy(v) for v in tree)
    return np.array(tree)


def _random_tree(seed):
    """A tree with the shapes AdamW and the projection meet: stacked layers,
    a list tail, vectors, a scalar."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed": {"w": f(64, 96)}, "slots": {"slot0": {"wq": {"w": f(2, 32, 48), "b": f(2, 48)},
                                                            "ln": {"scale": f(2, 32)}}},
            "tail": [{"wo": f(80, 64)}, {"w": f(3)}], "unembed": {"w": f(64, 96)}}


def test_tree_leaves_follow_jax_order():
    tree = _random_tree(0)
    want = [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    got = tree_leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a is not None and np.array_equal(a, b)


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_matches_the_reference(schedule):
    params, grads = _random_tree(1), _random_tree(2)
    grads = jax.tree_util.tree_map(lambda g: g * 0.3, grads)      # the clip is active
    lr_j = jcosine(3e-3, warmup=2, total=6) if schedule else 3e-3
    lr_t = cosine_schedule(3e-3, warmup=2, total=6) if schedule else 3e-3
    oj, ot = jadamw(lr_j), adamw(lr_t)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    sj = oj.init(pj)
    pt = lm_params_from_numpy(params, "cpu")
    st = ot.init(pt)
    update = jax.jit(oj.update)
    for i in range(4):
        gi = jax.tree_util.tree_map(lambda g: g * (1.0 + 0.5 * i), grads)
        pj, sj, mj = update(jax.tree_util.tree_map(jnp.asarray, gi), sj, pj)
        pt, st, mt = ot.update(lm_params_from_numpy(gi, "cpu"), st, pt)
        assert int(st.step) == int(sj.step) == i + 1
        assert abs(float(mt["lr"]) - float(mj["lr"])) <= ADAMW_TOL * float(mj["lr"])
        assert abs(float(mt["grad_norm"]) - float(mj["grad_norm"])) <= (
            ADAMW_TOL * float(mj["grad_norm"]))
        for name, a, b in (("params", pj, pt), ("mu", sj.mu, st.mu), ("nu", sj.nu, st.nu)):
            for x, y in zip(jax.tree_util.tree_leaves(a), tree_leaves(b)):
                x = np.asarray(x)
                np.testing.assert_allclose(y.numpy(), x, rtol=ADAMW_TOL,
                                           atol=ADAMW_TOL * float(np.abs(x).max()),
                                           err_msg=f"{name} at step {i + 1}")
    assert isinstance(st, AdamWState) and st.step.dtype == torch.int32


def test_cosine_schedule_matches_the_reference():
    lj, lt = jcosine(1e-3, warmup=5, total=40, floor=0.2), cosine_schedule(1e-3, 5, 40, 0.2)
    for step in range(0, 45):
        want = float(lj(jnp.asarray(step, jnp.int32)))
        got = float(lt(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= ADAMW_TOL * max(want, 1e-12), step


@pytest.mark.parametrize("vocab", [512, 49152])
def test_synthetic_batch_tokens_bitwise(vocab):
    """The Zipf draw's float32 power is taken in float64 and rounded: every
    token of 16 steps of (64, 1,024) equals the reference's."""
    key_j = jax.random.PRNGKey(3)
    key_t = key_from_numpy(np.asarray(key_j))
    for step in range(16):
        with jax.threefry_partitionable(True):
            want = jbatch(key_j, step, 64, 1024, vocab)
        got = synthetic_batch(key_t, step, 64, 1024, vocab, device="cpu")
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{k} at step {step}")


def test_synthetic_stream_is_step_indexed():
    s = SyntheticStream(0, 2, 16, 512, device="cpu")
    a, b = s.at_step(5), s.at_step(5)
    assert torch.equal(a["tokens"], b["tokens"])
    first = next(iter(s))
    assert torch.equal(first["tokens"], s.at_step(0)["tokens"])
    assert torch.equal(first["tokens"][:, 1:], first["labels"][:, :-1])


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_fake_grad_compression_bitwise(bits, monkeypatch):
    """Same gradients, same key: the port's dequantized leaves equal the
    reference's bit for bit (its codes through the kernel's words, one leaf
    longer than a chunk, a zero leaf at the 1e-30 scale)."""
    grads = _random_tree(4)
    grads["slots"]["slot0"]["ln"]["scale"][:] = 0.0
    key = jax.random.PRNGKey(7)
    with jax.threefry_partitionable(True):
        compress = jax.jit(lambda g, k: jcompress(g, bits, k))
        want = compress(grads, key)
    gt = lm_params_from_numpy(grads, "cpu")
    monkeypatch.setattr(collectives, "CHUNK", 1000)          # several chunks per leaf
    out = fake_grad_compression(gt, bits, key_from_numpy(np.asarray(key)))
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(out)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert all(a is b for a, b in zip(tree_leaves(out), tree_leaves(gt)))   # in place


@pytest.fixture(scope="module")
def smoke_params():
    cfg = dataclasses.replace(jconfigs.get_smoke_config("starcoder2_3b"), dtype="float32")
    with jax.threefry_partitionable(True):
        return jmodel.init_params(cfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("min_size", [4096, 2048])
def test_project_params_supports_bitwise(smoke_params, min_size):
    """The same weights give the same projected tree bit for bit: the same
    leaves projected, the same supports, the same values."""
    cfg_j, cfg_t = JIHT(sparsity=0.5, min_size=min_size), IHTConfig(sparsity=0.5, min_size=min_size)
    project = jax.jit(lambda p: jproject(p, cfg_j))
    want = project(smoke_params)
    pt = lm_params_from_numpy(_numpy(smoke_params), "cpu")
    got = project_params(pt, cfg_t)
    for a, b in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert sparsity_report(got, cfg_t) == jsparsity(want, cfg_j)
    for path, leaf in tree_flatten_with_path(got):
        if eligible(path, leaf, cfg_t):
            assert int(torch.count_nonzero(leaf)) == keep_count(leaf, cfg_t), path


def test_projection_keeps_a_tied_plateau_and_bf16():
    """A constant matrix keeps ``keep`` entries (the threshold-bin fill), as
    the reference's; a bfloat16 leaf is projected through its float32 copy."""
    w = np.ones((64, 64), np.float32)
    want = np.asarray(jproject_matrix(jnp.asarray(w, dtype=w.dtype), 2048))
    got = project_matrix_(torch.from_numpy(w.copy()), 2048)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(torch.count_nonzero(got)) == 2048
    wf = np.random.default_rng(2).standard_normal((48, 96)).astype(np.float32)
    wb = torch.from_numpy(wf).to(torch.bfloat16)
    want = jproject_matrix(jnp.asarray(wb.float().numpy(), dtype=jnp.bfloat16), 1000)
    got = project_matrix_(wb, 1000)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, dtype=np.float32))


def test_init_params_leaves_are_eligible_as_the_reference_names_them():
    """At the SMOKE width every dense ``w`` of starcoder2-3b is projected, the
    embedding included; biases and norms are not."""
    cfg = tconfigs.get_smoke_config("starcoder2_3b")
    params = init_params(cfg, prng.PRNGKey(0), device="cpu")
    names = {keystr(path) for path, leaf in tree_flatten_with_path(params)
             if eligible(path, leaf, IHTConfig(min_size=2048))}
    slot = "['slots']['slot0']"
    assert names == {"['embed']['w']", "['unembed']['w']"} | {
        f"{slot}{k}['w']" for k in ("['attn']['wq']", "['attn']['wk']", "['attn']['wv']",
                                    "['attn']['wo']", "['ffn']['wi']", "['ffn']['wo']")}


def test_tie_scan_in_pieces_is_the_whole_scan(monkeypatch):
    """The plain H_s counts threshold-bin ties with a cumsum taken in pieces
    on long rows (PyTorch's CUDA cumsum faults on a 1.13e9-entry row): the
    same supports as one scan, on a plateau whose ties straddle the pieces."""
    from repro_torch.kernels.hsthresh import ref as hs_ref

    x = torch.ones(2, 1000)
    x[:, ::7] = 2.0
    whole = hs_ref.hsthresh_ref(x, 300, 64)
    monkeypatch.setattr(hs_ref, "_SCAN_PIECE", 64)
    assert torch.equal(hs_ref.hsthresh_ref(x, 300, 64), whole)
    x = torch.arange(1000) % 3
    assert torch.equal(hs_ref._cumsum_last(x), torch.cumsum(x, -1))
