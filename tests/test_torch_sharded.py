"""The batch's rows split over ranks (``repro_torch.parallel.batch``,
``parallel.dist``, ``core.niht.qniht_batch_sharded``) on the CPU: four gloo
rank processes, spawned once for the module (``tests/torch_sharded_ranks.py``
holds what they run).

Within the port, bit for bit against the one-device run (on one intra-op
thread, as every rank runs: torch's CPU products also choose their order by
the thread count), at widths 2, 3 and
4 (padding where B = 10 does not divide): x and the whole trace of dense,
packed per_tensor and per_block (g = 8), matrix-free Fourier and Haar
wavelet solves, and the freeze rule; every rank's copy of the result;
``BatchServer`` chunks; the continuous scheduler at 8 slots on 4 ranks,
every request its ``reference_solve``; and a checkpointed solve stopped on
4 ranks by a signal that reached one of them, resumed at 2 ranks and on one
device.

Against the reference: the JAX package's own ``qniht_batch_sharded`` on 8
forced host devices, in one subprocess, on the same numpy inputs, within
the solves' tolerance (‖Δx‖ ≤ 1e-3·‖x‖ per row, ROADMAP ground rules).
"""
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sharded_ranks as ranks
from repro_torch.core.niht import qniht_batch_sharded
from repro_torch.launch.resilience import recover_resilient
from repro_torch.parallel import BatchServer, ContinuousScheduler, make_batch_mesh, segment_step
from repro_torch.parallel.dist import (
    BatchMesh,
    all_gather_rows,
    check_backend,
    spawn_ranks,
)
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread

REPO = Path(__file__).resolve().parents[1]
N_RANKS = 4
SOLVE_TOL = 1e-3

_REFERENCE_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_threefry_partitionable", True)
from repro.core import qniht_batch_sharded
from repro.sensing import make_mri_problem

inst = np.load(sys.argv[1])
key = jax.random.PRNGKey(0)
packed = dict(bits_phi=4, bits_y=8, requantize="fixed", backend="packed", with_trace=False)
cases = {
    "dense": ("gaussian", 5, 25, {}),
    "packed_per_tensor": ("gaussian", 5, 25, packed),
    "packed_per_block": ("gaussian", 5, 25, {**packed, "scale_granularity": "per_block",
                                             "group_size": 8}),
    "fourier": ("pixel", 24, 12, dict(real_signal=True, nonneg=True, bits_y=8,
                                      with_trace=False)),
    "wavelet": ("haar", 24, 12, dict(real_signal=True, nonneg=False, bits_y=8,
                                     with_trace=False)),
    "freeze": ("gaussian", 5, 25, dict(exit_tol=1e-5, with_trace=False)),
}
out = {}
for name, (which, s, n_iters, kw) in cases.items():
    if which == "gaussian":
        phi, Y = jnp.asarray(inst["phi"]), jnp.asarray(inst["Y"])
    else:
        phi = make_mri_problem(16, 24, 0.5, key, snr_db=None, sparsity_basis=which).op
        Y = jnp.asarray(inst["Y_" + which])
    res = qniht_batch_sharded(phi, Y, s, n_iters, n_devices=8, key=key, **kw)
    out[name] = np.asarray(res.x)
    out[name + "_resid_q"] = np.asarray(res.trace.resid_q)
    out[name + "_support_changed"] = np.asarray(res.trace.support_changed)
np.savez(sys.argv[2], **out)
print("REFERENCE_SHARDED_OK")
"""


@pytest.fixture(scope="module")
def run():
    """The ranks' results, the one-device results and the reference's."""
    with tempfile.TemporaryDirectory() as tmp:
        phi, Y = ranks.gaussian()
        inst = {"phi": phi.numpy(), "Y": Y.numpy()}
        for basis in ("pixel", "haar"):
            inst["Y_" + basis] = ranks.mri(basis)[1].numpy()
        np.savez(os.path.join(tmp, "inst.npz"), **inst)
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
        env.pop("JAX_PLATFORMS", None)
        with open(os.path.join(tmp, "reference.log"), "w") as log:
            ref = subprocess.Popen([sys.executable, "-c", _REFERENCE_SCRIPT,
                                    os.path.join(tmp, "inst.npz"),
                                    os.path.join(tmp, "reference.npz")],
                                   env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
            try:
                by_rank = spawn_ranks(ranks.run_matrix, N_RANKS, device="cpu", args=(tmp,))
                single = {name: ranks.solve(name) for name in ranks.CASES}
                code = ref.wait(timeout=300)
            finally:
                if ref.poll() is None:
                    ref.kill()
                    ref.wait()
        log = Path(tmp, "reference.log").read_text()
        assert code == 0 and "REFERENCE_SHARDED_OK" in log, log[-3000:]
        with np.load(os.path.join(tmp, "reference.npz")) as f:
            reference = {k: f[k] for k in f.files}
        resumed_1 = recover_resilient(*ranks.gaussian(), ranks.S, ranks.N_ITERS,
                                      checkpoint_dir=os.path.join(tmp, "resume_1"),
                                      ckpt_every=ranks.RESUME_EVERY, resume=True,
                                      key=ranks.key(), **ranks.PACKED)
        whole = ranks.resilient(os.path.join(tmp, "whole"))
        sch, arrivals = ranks.scheduler(journal_dir=os.path.join(tmp, "schedule"), resume=True)
        schedule_resumed = ({rid: r.x for rid, r in sch.run(arrivals).items()},
                            sch.n_drained)
    return {"by_rank": by_rank, "single": single, "reference": reference,
            "resumed_1": resumed_1, "whole": whole, "schedule_resumed": schedule_resumed}


def _same(a, b):
    """Bitwise equality of two float arrays, NaN markers included."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("width", ranks.WIDTHS)
@pytest.mark.parametrize("name", list(ranks.CASES))
def test_sharded_rows_are_the_one_device_rows_bitwise(run, name, width):
    """x and every trace leaf of every rank of the mesh equal the one-device
    solve's bit for bit (padding at widths 3 and 4)."""
    want = run["single"][name]
    for rank in range(width):
        x, trace = run["by_rank"][rank][("solve", name, width)]
        assert _same(x, want.x.numpy()), f"{name} x at width {width}, rank {rank}"
        for got, leaf in zip(trace, want.trace):
            assert _same(got, leaf.numpy()), f"{name} trace at width {width}, rank {rank}"


def _parts_at_a_support_decision(got, want, b):
    """Whether row b's two trajectories part at a support decision after
    residuals that agreed to the solves' tolerance (rtol 1e-3, atol 1e-5):
    the f32 orders of the two packages tipping a near-tie the other way (a
    knife edge, ROADMAP §3), not a different computation. Needs the residual
    trace (``with_trace``)."""
    rq_t, rq_j = got[0][:, b], want["resid_q"][:, b]
    ch_t, ch_j = got[3][:, b], want["support_changed"][:, b]
    parted = np.flatnonzero(ch_t != ch_j)
    if not parted.size or not np.isfinite(rq_j).all():
        return False
    k = parted[0]
    return bool(np.allclose(rq_t[:k], rq_j[:k], rtol=SOLVE_TOL, atol=1e-5))


@pytest.mark.parametrize("name", list(ranks.CASES))
def test_sharded_matches_the_reference_sharded_solve(run, name):
    """Width 4 against the JAX package's qniht_batch_sharded on 8 devices:
    every row within ‖Δx_b‖ ≤ 1e-3·‖x_b‖ with the same support, or parted
    from it at a support decision after residuals that agreed
    (:func:`_parts_at_a_support_decision`)."""
    got, trace = run["by_rank"][0][("solve", name, 4)]
    want = run["reference"][name]
    assert got.shape == want.shape
    ref_trace = {k: run["reference"][f"{name}_{k}"] for k in ("resid_q", "support_changed")}
    for b in range(got.shape[0]):
        close = (np.linalg.norm(got[b] - want[b]) <= SOLVE_TOL * np.linalg.norm(want[b])
                 and np.array_equal(got[b] != 0, want[b] != 0))
        assert close or _parts_at_a_support_decision(trace, ref_trace, b), (name, b)


@pytest.mark.parametrize("backend", ["dense", "packed"])
@pytest.mark.parametrize("width", [2, 4])
def test_batch_server_chunks_are_bitwise_across_widths(run, backend, width):
    want, shards = ranks.serve_chunks(None, backend)
    assert shards == 1
    for rank in range(width):
        xs, n = run["by_rank"][rank][("serve", backend, width)]
        assert n == width
        assert all(_same(g, w.numpy()) for g, w in zip(xs, want))


def test_scheduler_on_four_ranks_answers_each_request_as_its_reference_solve(run):
    single, refs = ranks.schedule()
    for rank in range(N_RANKS):
        got, _ = run["by_rank"][rank]["schedule"]
        assert sorted(got) == sorted(refs) == list(range(8))
        for rid, x in got.items():
            assert _same(x, refs[rid]), f"rank {rank}, request {rid}"
            assert _same(x, single[rid])


def test_scheduler_stopped_on_four_ranks_resumes_on_one_device(run):
    """A stop one rank saw ends every rank's run at the same tick; rank 0's
    journal then drains what they finished, and one device solves the rest,
    every answer the uninterrupted run's."""
    single, _ = ranks.schedule()
    stopped = [run["by_rank"][r]["schedule_stopped"] for r in range(N_RANKS)]
    tick, done = stopped[0]
    assert tick is not None and all(t == tick for t, _ in stopped)
    assert all(sorted(d) == sorted(done) for _, d in stopped)
    assert 1 <= len(done) < len(single)
    resumed, drained = run["schedule_resumed"]
    assert drained == len(done) and sorted(resumed) == sorted(single)
    for rid, x in resumed.items():
        assert _same(x, single[rid]), rid


def test_checkpoint_of_width_4_resumes_at_2_and_on_one_device_bitwise(run):
    """A stop requested on rank 1 alone ends every rank at the first
    segment's boundary; the checkpoint resumes at width 2 and on one device
    to the uninterrupted run's x and trace."""
    whole = run["whole"]
    assert all(run["by_rank"][r]["preempted_at"] == ranks.RESUME_EVERY for r in range(N_RANKS))
    for rank in range(2):
        x, trace = run["by_rank"][rank]["resumed_2"]
        assert _same(x, whole.x.numpy())
        assert all(_same(g, w.numpy()) for g, w in zip(trace, whole.trace))
    assert _same(run["resumed_1"].x.numpy(), whole.x.numpy())
    assert all(_same(g.numpy(), w.numpy()) for g, w in zip(run["resumed_1"].trace, whole.trace))


def test_one_device_meshes_and_what_is_refused_outside_a_process_group():
    phi, Y = ranks.gaussian()
    mesh = make_batch_mesh(1, "cpu")
    assert mesh == BatchMesh(size=1, rank=0, device=torch.device("cpu"))
    assert all_gather_rows(mesh, [Y])[0] is Y
    with pytest.raises(ValueError, match="spawn_ranks"):
        make_batch_mesh(2, "cpu")
    with pytest.raises(ValueError, match="spawn_ranks"):
        qniht_batch_sharded(phi, Y, ranks.S, 5, n_devices=2)
    with pytest.raises(ValueError, match="--devices"):
        BatchServer(phi, ranks.S, n_devices=2)
    with pytest.raises(ValueError, match="spawn_ranks"):
        ContinuousScheduler(phi, ranks.S, 5, slots=2, n_devices=2)
    with pytest.raises(TypeError, match="BatchMesh"):
        qniht_batch_sharded(phi, Y, ranks.S, 5, mesh=torch.device("cpu"))
    state = ranks.ContinuousScheduler(phi, ranks.S, 5, slots=2, n_devices=1)._state
    with pytest.raises(TypeError, match="BatchMesh"):
        segment_step(phi, state, 2, mesh=torch.device("cpu"), s=ranks.S)
    one = qniht_batch_sharded(phi, Y, ranks.S, 5, n_devices=1, key=ranks.key())
    assert _same(one.x.numpy(), ranks.qniht_batch(phi, Y, ranks.S, 5, key=ranks.key()).x.numpy())


def test_backends_are_explicit_and_nccl_takes_one_card_a_rank():
    assert check_backend(None, "cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="runs on CUDA"):
        check_backend("nccl", "cpu", 2)
    with pytest.raises(ValueError, match="unknown backend"):
        check_backend("mpi", "cpu", 2)
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="one card per rank"):
        check_backend("nccl", "cuda", count + 1)


def test_a_rank_that_raises_fails_the_launch():
    """No fallback and no hang: the error of rank 1 ends rank 0, waiting in a
    collective, and is raised to the caller."""
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        spawn_ranks(ranks.raise_on_rank_1, 2, device="cpu")
