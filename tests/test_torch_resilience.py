"""The port's durability layer: checkpoints (atomic tmp→rename, manifest,
torn checkpoints skipped, pruning), the preemption guard and restart
supervisor, and the segmented checkpointed solve that resumes bit for bit.

Tolerance: bitwise. A resumed solve has the bits of the uninterrupted
checkpointed run and the x (and every trace field but ``resid_true``, whose
Φ is the packed operator in the checkpointed runner, as in the reference) of
``qniht_batch``. Against the reference: the manifest spells the same leaf
paths, and each package restores the other's checkpoint.
"""
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.niht import (
    IHTTrace,
    qniht_batch,
    solver_init,
    solver_result,
    solver_segment,
)
from repro_torch.launch import recover
from repro_torch.launch.resilience import Preempted, recover_resilient
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import PreemptionGuard, StepTimer, run_with_restarts
from test_torch_niht import gaussian_case
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


REPO = Path(__file__).resolve().parents[1]
S = 5


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


def _problem(batch=4, seed=3):
    phi, Y, _ = gaussian_case(48, 96, S, batch, seed=seed)
    key = convert.key_from_numpy(np.asarray(jax.random.PRNGKey(seed)))
    return torch.from_numpy(phi), torch.from_numpy(Y), key


CONFIGS = {
    "fp": dict(),
    "pair": dict(bits_phi=4, bits_y=8, requantize="pair"),
    "packed": dict(bits_phi=4, bits_y=8, requantize="fixed", backend="packed"),
    "freeze": dict(early_exit=True, exit_tol=1e-5),
}


def _same(a, b):
    assert torch.equal(a.x, b.x)
    for name, u, v in zip(a.trace._fields, a.trace, b.trace):
        assert torch.equal(u.nan_to_num(), v.nan_to_num()), name


class _Guard:
    """A preemption request at the n-th poll."""

    def __init__(self, at):
        self.at, self.polls = at, 0

    @property
    def requested(self):
        self.polls += 1
        return self.polls >= self.at


# --- checkpoint ------------------------------------------------------------------

def _tree():
    return IHTTrace(resid_q=torch.arange(6, dtype=torch.float32).reshape(2, 3),
                    resid_true=torch.tensor([True, False]),
                    mu=torch.tensor(3, dtype=torch.int32),
                    support_changed={"a": torch.ones(2, dtype=torch.complex64),
                                     "b": [torch.zeros(1, dtype=torch.int64)]},
                    backtracks=np.arange(4, dtype=np.uint8))


def _tree_equal(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (_, u), (_, v) in zip(fa, fb):
        assert type(u) is type(v)
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))
        assert np.asarray(u).dtype == np.asarray(v).dtype


@pytest.mark.parametrize("async_", [False, True])
def test_checkpoint_round_trip(tmp_path, async_):
    t = ckpt.save(str(tmp_path), 7, _tree(), async_=async_)
    if t is not None:
        t.join()
    assert ckpt.available_steps(str(tmp_path)) == [7] and ckpt.latest_step(str(tmp_path)) == 7
    _tree_equal(ckpt.restore(str(tmp_path), 7, _tree()), _tree())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))


def test_checkpoint_leaf_paths_are_the_reference_s(tmp_path):
    """The port's manifest names a SolverState's leaves as the reference's does."""
    from repro.core.niht import solver_init as jax_solver_init
    from repro.train import checkpoint as jax_ckpt

    phi, Y, key = _problem(2)
    jax_ckpt.save(str(tmp_path / "j"), 1, jax_solver_init(jnp.asarray(phi.numpy()),
                                                          jnp.asarray(Y.numpy()), S, 4))
    ckpt.save(str(tmp_path / "t"), 1, solver_init(phi, Y, S, 4, key=key))
    paths = [[e["path"] for e in json.load(open(tmp_path / d / "step_00000001"
                                                / "manifest.json"))["leaves"]]
             for d in ("j", "t")]
    assert paths[0] == paths[1]


def test_jax_checkpoint_restores_into_the_port_s_state(tmp_path):
    """A checkpoint the reference wrote restores into the port's SolverState
    with the same values and dtypes (the key as the reference's uint32 words:
    the port holds them in int64)."""
    from repro.core.niht import solver_init as jax_solver_init, solver_segment as jax_segment
    from repro.train import checkpoint as jax_ckpt

    phi, Y, key = _problem(2)
    jkey = jax.random.PRNGKey(3)
    st_j = jax_segment(jnp.asarray(phi.numpy()), jax_solver_init(
        jnp.asarray(phi.numpy()), jnp.asarray(Y.numpy()), S, 6, key=jkey), 3, s=S)
    jax_ckpt.save(str(tmp_path), 3, st_j)
    target = solver_init(phi, Y, S, 6, key=key)._replace(key=np.zeros(2, np.uint32))
    st_t, step = ckpt.restore_latest(str(tmp_path), target)
    assert step == 3 and int(st_t.k) == 3
    for (name, u), (_, v) in zip(ckpt._flatten(st_t), ckpt._flatten(st_j)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=name)
        assert np.asarray(u).dtype == np.asarray(v).dtype, name
    assert torch.equal(convert.key_from_numpy(st_t.key), key)


def test_checkpoint_pruning_keeps_the_newest(tmp_path):
    for step in range(1, 6):
        ckpt.save(str(tmp_path), step, _tree(), keep=2)
    assert ckpt.available_steps(str(tmp_path)) == [4, 5]
    ckpt.save(str(tmp_path), 6, _tree(), keep=0)
    assert ckpt.available_steps(str(tmp_path)) == [4, 5, 6]


def test_torn_checkpoints_are_skipped(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        ckpt.save(d, step, _tree(), keep=10)
    man = os.path.join(d, "step_00000003", "manifest.json")
    m = json.load(open(man))
    m["status"] = "writing"
    json.dump(m, open(man, "w"))
    with open(os.path.join(d, "step_00000002", "leaf_00000.npy"), "r+b") as f:
        f.truncate(8)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    state, step = ckpt.restore_latest(d, _tree())
    assert step == 1
    _tree_equal(state, _tree())
    assert ckpt.restore_latest(str(tmp_path / "none"), _tree()) == (None, None)


def test_checkpoint_refuses_another_shape_or_dtype(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore(str(tmp_path), 1, {"x": torch.zeros(3, dtype=torch.float64)})
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 1, {"y": torch.zeros(3)})
    man = tmp_path / "step_00000001" / "manifest.json"
    m = json.load(open(man))
    m["leaves"][0]["dtype"] = "int32"
    json.dump(m, open(man, "w"))
    with pytest.raises(ValueError, match="manifest"):
        ckpt.restore(str(tmp_path), 1, {"x": torch.zeros(3)})


# --- the segmented, checkpointed solve ---------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("every", [1, 7, 30])
def test_checkpointed_run_is_qniht_batch(tmp_path, name, every):
    phi, Y, key = _problem()
    kw = dict(CONFIGS[name], key=key)
    ref = qniht_batch(phi, Y, S, 30, **kw)
    got = recover_resilient(phi, Y, S, 30, checkpoint_dir=str(tmp_path), ckpt_every=every,
                            **kw)
    assert torch.equal(got.x, ref.x)
    for field in ("resid_q", "mu", "support_changed", "backtracks"):
        assert torch.equal(getattr(got.trace, field), getattr(ref.trace, field)), field
    if name != "packed":
        assert torch.equal(got.trace.resid_true, ref.trace.resid_true)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_preempted_then_resumed_is_bit_identical(tmp_path, name):
    phi, Y, key = _problem()
    kw = dict(CONFIGS[name], key=key)
    whole = recover_resilient(phi, Y, S, 30, checkpoint_dir=str(tmp_path / "a"),
                              ckpt_every=7, **kw)
    d = str(tmp_path / "b")
    with pytest.raises(Preempted) as exc:
        recover_resilient(phi, Y, S, 30, checkpoint_dir=d, ckpt_every=7, guard=_Guard(2),
                          **kw)
    assert exc.value.k == 14 and ckpt.latest_step(d) == 14
    resumed = recover_resilient(phi, Y, S, 30, checkpoint_dir=d, ckpt_every=7, resume=True,
                                **kw)
    _same(resumed, whole)


def test_real_sigterm_preempts_after_the_running_segment(tmp_path):
    phi, Y, key = _problem(3)
    kw = dict(CONFIGS["packed"], key=key)
    whole = recover_resilient(phi, Y, S, 20, checkpoint_dir=str(tmp_path / "a"),
                              ckpt_every=5, **kw)
    d = str(tmp_path / "b")
    with PreemptionGuard() as guard:
        signal.raise_signal(signal.SIGTERM)
        with pytest.raises(Preempted) as exc:
            recover_resilient(phi, Y, S, 20, checkpoint_dir=d, ckpt_every=5, guard=guard, **kw)
    assert exc.value.k == 5
    _same(recover_resilient(phi, Y, S, 20, checkpoint_dir=d, ckpt_every=5, resume=True, **kw),
          whole)


def test_resume_from_nothing_or_a_torn_checkpoint_starts_fresh(tmp_path):
    phi, Y, key = _problem(3)
    ref = qniht_batch(phi, Y, S, 12)
    _same(recover_resilient(phi, Y, S, 12, checkpoint_dir=str(tmp_path / "e"), ckpt_every=5,
                            resume=True), ref)
    d = str(tmp_path / "t")
    with pytest.raises(Preempted):
        recover_resilient(phi, Y, S, 12, checkpoint_dir=d, ckpt_every=5,
                          guard=type("G", (), {"requested": True})())
    with open(os.path.join(d, "step_00000005", "leaf_00001.npy"), "r+b") as f:
        f.truncate(8)
    _same(recover_resilient(phi, Y, S, 12, checkpoint_dir=d, ckpt_every=5, resume=True), ref)


def test_recover_resilient_validation(tmp_path):
    phi, Y, key = _problem(2)
    with pytest.raises(TypeError, match="unroll"):
        recover_resilient(phi, Y, S, 10, checkpoint_dir=str(tmp_path), unroll=4)
    with pytest.raises(ValueError, match="ckpt_every"):
        recover_resilient(phi, Y, S, 10, checkpoint_dir=str(tmp_path), ckpt_every=0)


def test_segments_through_disk_between_calls(tmp_path):
    """A state saved after each segment and restored into a fresh target
    goes on to the one-shot bits."""
    phi, Y, key = _problem()
    kw = CONFIGS["packed"]
    ref = qniht_batch(phi, Y, S, 20, key=key, **kw)
    st = solver_init(phi, Y, S, 20, key=key, **kw)
    for step in (6, 12, 20):
        st = solver_segment(phi, st, step - int(st.k), s=S, **kw)
        ckpt.save(str(tmp_path), step, st)
        st, _ = ckpt.restore_latest(str(tmp_path), solver_init(phi, Y, S, 20, key=key, **kw))
    _same(solver_result(st), ref)


# --- fault ---------------------------------------------------------------------------------

@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGINT])
def test_guard_sets_requested_and_restores_handlers(sig):
    prev = signal.getsignal(sig)
    with PreemptionGuard() as g:
        assert not g.requested
        signal.raise_signal(sig)
        assert g.requested
    assert signal.getsignal(sig) is prev


def test_run_with_restarts_backoff_and_preempted_retry(tmp_path):
    delays, calls = [], []

    def body(attempt):
        calls.append(attempt)
        if attempt < 3:
            raise RuntimeError("boom")
        return "ok"

    assert run_with_restarts(body, max_restarts=3, backoff=1.0, max_backoff=1.5,
                             sleep=delays.append) == "ok"
    assert calls == [0, 1, 2, 3] and delays == [1.0, 1.5, 1.5]
    with pytest.raises(RuntimeError):
        run_with_restarts(lambda a: (_ for _ in ()).throw(RuntimeError()), max_restarts=1,
                          sleep=lambda _: None)

    phi, Y, key = _problem(3)
    ref = qniht_batch(phi, Y, S, 20)
    guard = _Guard(1)
    out = run_with_restarts(lambda attempt: recover_resilient(
        phi, Y, S, 20, checkpoint_dir=str(tmp_path), ckpt_every=5, resume=attempt > 0,
        guard=guard if attempt == 0 else None), sleep=lambda _: None)
    _same(out, ref)


def test_step_timer_flags_a_straggler(monkeypatch):
    import repro_torch.train.fault as fault

    clock = iter([0.0, 1.0, 2.0, 3.0, 10.0])
    monkeypatch.setattr(fault.time, "monotonic", lambda: next(clock))
    t = StepTimer(window=3)
    for _ in range(5):
        t.tick()
    assert t.times == [1.0, 1.0, 7.0] and t.p_max == 7.0 and t.straggling(2.0)


# --- the CLI ------------------------------------------------------------------------------

def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


@pytest.mark.parametrize("argv", [["--config", "gaussian-smoke", "--backend", "packed",
                                   "--bits-phi", "8", "--batch", "3"],
                                  ["--config", "lofar-smoke", "--backend", "packed"],
                                  ["--config", "mri-wavelet-smoke"]])
def test_recover_cli_checkpoint_resume_prints_the_same_line(tmp_path, argv, capsys):
    recover.main(["--device", "cpu", *argv])
    plain = capsys.readouterr().out.strip().splitlines()[-1]
    d = str(tmp_path)
    recover.main(["--device", "cpu", *argv, "--checkpoint-dir", d, "--ckpt-every", "6"])
    out = capsys.readouterr().out.strip().splitlines()
    assert "[resilience] fresh start" in out[0] and "checkpointed" in out[1]
    recover.main(["--device", "cpu", *argv, "--checkpoint-dir", d, "--resume"])
    resumed = capsys.readouterr().out.strip().splitlines()
    assert "resumed from step" in resumed[0]
    strip = lambda line: line.split(" wall_s=")[0]   # noqa: E731
    assert strip(out[-1]) == strip(resumed[-1])
    if "gaussian" not in argv[1]:
        assert strip(out[-1]).split(": ")[1].split()[:3] == strip(plain).split(": ")[1].split()[:3]


def test_recover_cli_sigterm_then_resume(tmp_path):
    """A real SIGTERM to the CLI process, sent when it says it has started
    (its preemption guard is in place by then): it finishes the running
    segment, checkpoints, says so and exits 0; --resume finishes with the
    uninterrupted run's final state."""
    base = [sys.executable, "-m", "repro_torch.launch.recover", "--config", "lofar-smoke",
            "--backend", "packed", "--device", "cpu", "--batch", "2", "--ckpt-every", "2"]
    whole = str(tmp_path / "whole")
    subprocess.run([*base, "--checkpoint-dir", whole], check=True, capture_output=True,
                   env=_env(), cwd=REPO, timeout=300)
    d = str(tmp_path / "killed")
    proc = subprocess.Popen([*base, "--checkpoint-dir", d], stdout=subprocess.PIPE, text=True,
                            env=_env(), cwd=REPO)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if "fresh start" in line:
            proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=300) == 0
    stopped = [ln for ln in lines if "preempted at iteration" in ln]
    assert stopped, lines
    n_iters = recover.CONFIGS["lofar-smoke"].n_iters
    k = int(stopped[0].split("preempted at iteration ")[1].split(";")[0])
    assert 2 <= k < n_iters and ckpt.latest_step(d) == k
    subprocess.run([*base, "--checkpoint-dir", d, "--resume"], check=True,
                   capture_output=True, env=_env(), cwd=REPO, timeout=300)
    cfg = recover.CONFIGS["lofar-smoke"]
    phi, Y, _ = recover.lofar_instance(cfg, 0, 2, "cpu")
    target = solver_init(phi, Y, cfg.n_sources, n_iters, real_signal=True)
    a, _ = ckpt.restore_latest(whole, target)
    b, _ = ckpt.restore_latest(d, target)
    assert int(a.k) == int(b.k) == n_iters
    for u, v in zip(ckpt._flatten(a), ckpt._flatten(b)):
        assert torch.equal(u[1].nan_to_num(), v[1].nan_to_num()), u[0]


def test_recover_cli_sigterm_to_four_ranks_then_resume_at_two(tmp_path, capsys):
    """A real SIGTERM to the CLI of ``--devices 4``, sent once the first
    segment is checkpointed (every rank's guard is in place by then): the CLI
    passes it on, the ranks agree to stop at the next segment, rank 0 writes
    the checkpoint and says so, and the CLI exits 0. ``--resume`` at
    ``--devices 2`` prints the one-device run's line, x_digest included."""
    argv = ["--config", "gaussian-smoke", "--backend", "packed", "--bits-phi", "4",
            "--device", "cpu", "--batch", "10", "--ckpt-every", "1"]
    recover.main([*argv, "--checkpoint-dir", str(tmp_path / "whole")])
    whole = capsys.readouterr().out.strip().splitlines()[-1]
    d = str(tmp_path / "killed")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.recover", *argv,
                             "--checkpoint-dir", d, "--devices", "4"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=_env(), cwd=REPO)
    lines = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith("[resilience] k=1/"):
            proc.send_signal(signal.SIGTERM)
    err = proc.stderr.read()
    assert proc.wait(timeout=300) == 0, err[-3000:]
    stopped = [ln for ln in lines if "preempted at iteration" in ln]
    assert len(stopped) == 1, lines
    k = int(stopped[0].split("preempted at iteration ")[1].split(";")[0])
    assert 1 <= k < recover.CONFIGS["gaussian-smoke"].n_iters and ckpt.latest_step(d) == k
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.recover", *argv,
                          "--checkpoint-dir", d, "--devices", "2", "--resume"],
                         capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    resumed = out.stdout.strip().splitlines()
    assert resumed[0] == f"[resilience] resumed from step {k} (k={k})"
    assert resumed[-1].split(" wall_s=")[0] == whole.split(" wall_s=")[0]


@pytest.mark.parametrize("argv", [["--resume"], ["--ckpt-every", "3"],
                                  ["--checkpoint-dir", "d", "--ckpt-every", "0"]])
def test_recover_cli_checkpoint_flag_errors(argv):
    with pytest.raises(SystemExit) as exc:
        recover.main(["--device", "cpu", "--config", "gaussian-smoke", *argv])
    assert exc.value.code == 2


@pytest.mark.cuda
def test_resume_on_the_card_is_bit_identical(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    phi, Y, key = (t.cuda() if t.dtype != torch.int64 else t for t in _problem())
    kw = dict(CONFIGS["packed"], key=key)
    whole = recover_resilient(phi, Y, S, 30, checkpoint_dir=str(tmp_path / "a"),
                              ckpt_every=7, **kw)
    d = str(tmp_path / "b")
    with pytest.raises(Preempted):
        recover_resilient(phi, Y, S, 30, checkpoint_dir=d, ckpt_every=7, guard=_Guard(2),
                          **kw)
    resumed = recover_resilient(phi, Y, S, 30, checkpoint_dir=d, ckpt_every=7, resume=True,
                                **kw)
    assert resumed.x.is_cuda
    _same(resumed, whole)
