"""The port's serving path (``repro_torch.launch.serve``,
``parallel.batch.BatchServer``) and the PRNG draws its workloads use,
against the JAX reference and within the port.

* ``random.permutation``, ``rademacher`` and ``bernoulli``: bit for bit
  against ``jax.random``.
* The workloads (``build_stream``, ``build_requests``): arrival ticks,
  priorities, budgets, supports and signs bit for bit; Φ and y within 1e-6
  relative (``random.normal`` is within 1e-6 of ``jax.random.normal``).
* Served answers on the same numpy Φ, y and keys: ‖Δx_b‖ ≤ 1e-3·‖x_b‖ per
  row against the reference's ``BatchServer`` and ``ContinuousScheduler``
  (no row of these inputs splits at a knife edge; one that did would fail
  here, to be shown by the per-row rule of ``chip_smoke.py``, never seeded
  away).
* Within the port, bitwise: a chunk is ``qniht_batch`` of the user-level
  configuration; the CLI's ``--verify``; the kill/resume digests.
"""
import json
import re
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import serve_batch as jcfgs
from repro.launch import serve as jserve
from repro.parallel import BatchServer as JServer, ContinuousScheduler as JScheduler
from repro_torch import convert
from repro_torch import random as prng
from repro_torch.configs import SERVE_CONFIGS, serve_batch
from repro_torch.core.niht import qniht_batch
from repro_torch.launch import serve
from repro_torch.parallel import BatchServer, ContinuousScheduler, Request, pad_batch
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


REPO = Path(__file__).resolve().parents[1]
SEEDS = [0, 1, 42, 302, -7]


@pytest.fixture(autouse=True)
def _partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


def _j(a):
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


def _pair(seed):
    jk = jax.random.PRNGKey(seed)
    return jk, convert.key_from_numpy(np.asarray(jk))


def _env():
    import os

    return dict(os.environ, PYTHONPATH=str(REPO / "src"))


# --- the PRNG draws -------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 96, 1024, 2000])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_matches_jax(seed, n):
    """One sort round for n up to 1,625, two at 2,000."""
    jk, tk = _pair(seed)
    want = np.asarray(jax.random.permutation(jk, n))
    got = prng.permutation(tk, n).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["int32", "float32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_rademacher_matches_jax(seed, dtype):
    jk, tk = _pair(seed)
    want = np.asarray(jax.random.rademacher(jk, (3, 64), getattr(jnp, dtype)))
    got = prng.rademacher(tk, (3, 64), dtype=getattr(torch, dtype)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_bernoulli_matches_jax(seed, p):
    jk, tk = _pair(seed)
    np.testing.assert_array_equal(prng.bernoulli(tk, p, (257,)).numpy(),
                                  np.asarray(jax.random.bernoulli(jk, p, (257,))))


# --- the workloads --------------------------------------------------------------------------

def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


@pytest.mark.parametrize("name", ["serve-gaussian-smoke", "serve-gaussian-fault"])
def test_build_stream_matches_reference(name):
    cfg = SERVE_CONFIGS[name]
    jk, tk = _pair(cfg.seed)
    jphi, jchunks, jtruths = jserve.build_stream(getattr(jcfgs, _const(name)), jk)
    phi, chunks, truths = serve.build_stream(cfg, tk, "cpu")
    assert _rel(phi, jphi) <= 1e-6
    for c, jc, t, jt in zip(chunks, jchunks, truths, jtruths):
        np.testing.assert_array_equal(t.numpy() != 0, np.asarray(jt) != 0)
        np.testing.assert_array_equal(np.sign(t.numpy()), np.sign(np.asarray(jt)))
        assert _rel(t, jt) <= 1e-6
        for b in range(cfg.chunk):
            assert _rel(c[b], jc[b]) <= 1e-6


def _const(name):
    return {v.name: k for k, v in vars(serve_batch).items()
            if isinstance(v, (serve_batch.ServeConfig, serve_batch.ContinuousServeConfig))}[name]


@pytest.mark.parametrize("name", ["serve-continuous-smoke", "serve-continuous-packed"])
def test_build_requests_matches_reference(name):
    cfg = SERVE_CONFIGS[name]
    jk, tk = _pair(cfg.seed)
    jphi, jarr, jtruths, jhard = jserve.build_requests(getattr(jcfgs, _const(name)), jk)
    phi, arr, truths, hard = serve.build_requests(cfg, tk, "cpu")
    assert hard == jhard
    assert [(t, r.rid, r.priority, r.deadline, r.n_iters) for t, r in arr] == \
        [(t, r.rid, r.priority, r.deadline, r.n_iters) for t, r in jarr]
    assert _rel(phi, jphi) <= 1e-6
    for (_, r), (_, jr) in zip(arr, jarr):
        t, jt = truths[r.rid].numpy(), np.asarray(jtruths[r.rid])
        np.testing.assert_array_equal(np.sign(t), np.sign(jt))
        assert _rel(t, jt) <= 1e-6 and _rel(r.y, jr.y) <= 1e-6


def test_all_eight_configs_are_the_reference_s():
    import dataclasses

    assert len(SERVE_CONFIGS) == 8
    for name, cfg in SERVE_CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(getattr(jcfgs, _const(name)))


# --- served answers against the reference ---------------------------------------------------

@pytest.mark.parametrize("backend", ["dense", "packed"])
def test_batch_server_matches_reference(backend):
    """serve-gaussian-smoke's chunks (the reference's Φ and Y), the chunk keys
    of the CLI: each row within 1e-3 of the reference server's."""
    jcfg = jcfgs.SMOKE
    jk, tk = _pair(jcfg.seed)
    phi, chunks, _ = jserve.build_stream(jcfg, jk)
    kw = dict(bits_phi=4, bits_y=8, backend="packed") if backend == "packed" else {}
    jsrv = JServer(phi, jcfg.s, jcfg.n_iters, key=jk, exit_tol=jcfg.exit_tol, **kw)
    tsrv = BatchServer(torch.from_numpy(np.array(phi)), jcfg.s, jcfg.n_iters, key=tk,
                       exit_tol=jcfg.exit_tol, **kw)
    for ci, Y in enumerate(chunks):
        jck = jax.random.fold_in(jk, 1000 + ci)
        xj = np.asarray(jsrv.submit(Y, jck).x)
        xt = tsrv.submit(torch.from_numpy(np.array(Y)),
                         convert.key_from_numpy(np.asarray(jck))).x.numpy()
        for b in range(jcfg.chunk):
            assert np.linalg.norm(xt[b] - xj[b]) <= 1e-3 * np.linalg.norm(xj[b]), (ci, b)
    assert tsrv.compile_cache_keys == ((jcfg.chunk, jcfg.m),) and tsrv.n_chunks == 2


@pytest.mark.parametrize("packed", [False, True])
def test_scheduler_matches_reference_on_the_smoke_trace(packed):
    """serve-continuous-smoke's trace (the reference's Φ and y): the same
    decisions and each answer within 1e-3 of the reference scheduler's."""
    jcfg = jcfgs.CONTINUOUS_SMOKE
    jk, tk = _pair(jcfg.seed)
    phi, arr, _, _ = jserve.build_requests(jcfg, jk)
    kw = dict(bits_phi=4, bits_y=8, backend="packed") if packed else {}
    common = dict(slots=jcfg.slots, seg_len=jcfg.seg_len, exit_tol=jcfg.exit_tol, **kw)
    j = JScheduler(phi, jcfg.s, jcfg.n_iters, key=jk, **common)
    jr = j.run(arr)
    t = ContinuousScheduler(torch.from_numpy(np.array(phi)), jcfg.s, jcfg.n_iters, key=tk,
                            **common)
    tr = t.run([(tick, Request(rid=r.rid, y=np.asarray(r.y), priority=r.priority,
                               deadline=r.deadline, n_iters=r.n_iters)) for tick, r in arr])
    assert t.log == j.log
    for rid, rep in jr.items():
        xj = np.asarray(rep.x)
        assert np.linalg.norm(tr[rid].x - xj) <= 1e-3 * np.linalg.norm(xj), rid


# --- BatchServer within the port -------------------------------------------------------------

def _smoke_chunk():
    cfg = serve_batch.SMOKE
    _, tk = _pair(cfg.seed)
    phi, chunks, _ = serve.build_stream(cfg, tk, "cpu")
    return cfg, tk, phi, chunks[0]


@pytest.mark.parametrize("exit_tol", [0.0, 1e-5])
def test_prepacked_server_is_the_packed_solve(exit_tol):
    """Pack once at construction: with the construction key K, a chunk
    submitted under K is qniht_batch(backend="packed", key=K), bit for bit."""
    cfg, tk, phi, Y = _smoke_chunk()
    kw = dict(bits_phi=4, bits_y=8, backend="packed", requantize="fixed")
    srv = BatchServer(phi, cfg.s, cfg.n_iters, key=tk, exit_tol=exit_tol, **kw)
    want = qniht_batch(phi, Y, cfg.s, cfg.n_iters, key=tk, early_exit=True,
                       exit_tol=exit_tol, with_trace=False, **kw)
    assert torch.equal(srv.submit(Y, tk).x, want.x)
    assert torch.equal(srv.submit(Y).x, want.x)


def test_masked_submit_and_journal_replay(tmp_path):
    cfg, tk, phi, Y = _smoke_chunk()
    mask = torch.tensor([True] * 5 + [False] * 3)
    srv = BatchServer(phi, cfg.s, cfg.n_iters, key=tk, journal_dir=str(tmp_path))
    x = srv.submit(Y, row_mask=mask).x
    assert srv.n_items == 5 and not x[5:].any()
    zeroed = torch.where(mask[:, None], Y, torch.zeros_like(Y))
    assert torch.equal(x, BatchServer(phi, cfg.s, cfg.n_iters, key=tk).submit(zeroed).x)
    again = BatchServer(phi, cfg.s, cfg.n_iters, key=tk, journal_dir=str(tmp_path),
                        resume=True)
    res = again.submit(Y, row_mask=mask)
    assert again.n_drained == 1 and torch.equal(res.x, x)
    assert torch.isnan(res.trace.mu).all() and res.trace.mu.shape == (cfg.n_iters, 8)
    with pytest.raises(ValueError, match="journal mismatch"):
        BatchServer(phi, cfg.s, cfg.n_iters, key=tk, journal_dir=str(tmp_path),
                    resume=True).submit(Y * 2, row_mask=mask)


def test_server_stream_keys_and_validation():
    cfg, tk, phi, Y = _smoke_chunk()
    srv = BatchServer(phi, cfg.s, 15, key=tk)
    outs = list(srv.serve([Y, Y * 0.5, Y], keys=iter([prng.fold_in(tk, 1)])))
    assert len(outs) == 3 and srv.n_chunks == 3 and srv.n_shards == 1
    assert torch.equal(outs[2].x, srv.submit(Y).x)
    with pytest.raises(ValueError, match="bits_phi"):
        BatchServer(phi, cfg.s, backend="packed")
    with pytest.raises(ValueError, match="resume"):
        BatchServer(phi, cfg.s, resume=True)
    with pytest.raises(ValueError, match=r"\(B, M\)"):
        srv.submit(Y[0])
    with pytest.raises(ValueError, match="spawn_ranks"):
        BatchServer(phi, cfg.s, n_devices=2)


def test_pad_batch():
    Y = torch.ones((5, 3))
    Yp, b = pad_batch(Y, 4)
    assert b == 5 and Yp.shape == (8, 3) and not Yp[5:].any()
    assert pad_batch(Y, 5)[0] is Y


# --- the CLI --------------------------------------------------------------------------------

def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("policy", ["continuous", "lockstep"])
def test_cli_scheduler_verify_on_the_cpu(policy, capsys, tmp_path):
    metrics = tmp_path / "m.json"
    serve.main(["--device", "cpu", "--config", "serve-continuous-smoke", "--scheduler", policy,
                "--verify", "--metrics-json", str(metrics)])
    lines = _last_line(capsys)
    assert lines[0] == "[serve] verified 20 requests bitwise against standalone solves"
    assert lines[-1].startswith(f"[serve] serve-continuous-smoke: scheduler={policy} ")
    out = json.loads(metrics.read_text())
    assert out["completed"] == 20 and 0 < out["slot_occupancy"] <= 1
    assert out["latency_p50_s"] <= out["latency_p99_s"]


def test_cli_chunked_on_the_cpu(capsys):
    serve.main(["--device", "cpu", "--config", "serve-gaussian-smoke", "--devices", "1"])
    lines = _last_line(capsys)
    assert [ln.split(" x_digest=")[0] for ln in lines[:2]] == ["[serve] chunk 0",
                                                               "[serve] chunk 1"]
    assert "devices=1 chunks=2 chunks_served=2 chunks_drained=0" in lines[-1]


def test_cli_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--config", "serve-gaussian-smoke"])


@pytest.mark.parametrize("argv,says", [
    (["--dist-backend", "gloo"], "--dist-backend names the backend of the ranks"),
])
def test_cli_refuses_what_is_not_ported(argv, says, capsys):
    """``--devices N`` is ported (below); a backend without N > 1 ranks is
    refused."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--config", "serve-gaussian-smoke", *argv])
    assert exc.value.code == 2
    assert says in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--config", "serve-gaussian-smoke"],
    ["--config", "serve-continuous-smoke", "--scheduler", "continuous", "--verify"],
])
def test_cli_on_two_ranks_is_the_one_device_run(argv, capfd):
    """``--devices 2`` (two gloo ranks): rank 0 alone prints; the chunk
    digests (chunked) or the verified answers and the metrics (scheduler)
    are the one-device run's, and the last line says devices=2."""
    serve.main(["--device", "cpu", *argv])
    one = capfd.readouterr().out.strip().splitlines()
    serve.main(["--device", "cpu", *argv, "--devices", "2"])
    two = capfd.readouterr().out.strip().splitlines()
    assert len(one) == len(two)
    assert _digests("\n".join(one)) == _digests("\n".join(two))
    assert "devices=1 " in one[-1] and "devices=2 " in two[-1]

    def fields(line):       # the metrics the clock does not move
        return [f for f in line.split() if not re.match(r"(wall_s|compile_chunk_s|"
                                                        r"steady_chunk_s|items_per_s|"
                                                        r"latency_p\d+_s|devices)=", f)]

    assert fields(one[-1]) == fields(two[-1])


@pytest.mark.parametrize("flag", ["--sanitize", "--profile-dir"])
def test_cli_sanitize_and_profile_dir_on_the_cpu(flag, tmp_path, capsys):
    """The two flags the port once refused: ``--sanitize`` ends with the
    reference's ``[sanitize] ok ...`` line and puts the counter's fields in
    the metrics; ``--profile-dir`` writes a Chrome trace of the loop."""
    argv = [flag] if flag == "--sanitize" else [flag, str(tmp_path / "prof")]
    serve.main(["--device", "cpu", "--config", "serve-gaussian-smoke", *argv])
    lines = _last_line(capsys)
    assert "devices=1 chunks=2 chunks_served=2 chunks_drained=0" in lines[-1]
    if flag == "--sanitize":
        assert lines[-2] == ("[sanitize] ok compiles=0 compiles_after_warmup=0 "
                             "compile_s=0.00 debug_nans=on debug_infs=on")
        assert "sanitize_compiles=0 sanitize_compiles_after_warmup=0" in lines[-1]
    else:
        trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
        names = {e.get("name") for e in trace["traceEvents"]}
        assert "aten::mm" in names or "aten::matmul" in names


@pytest.mark.parametrize("argv", [["--resume"], ["--chunks", "0"],
                                  ["--scheduler", "continuous"], ["--devices", "0"]])
def test_cli_flag_errors(argv):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--config", "serve-gaussian-smoke", *argv])
    assert exc.value.code == 2


def _digests(text):
    return re.findall(r"chunk (\d+) x_digest=([0-9a-f]+)", text)


@pytest.mark.parametrize("config", ["serve-gaussian-fault", "serve-gaussian-fault-packed"])
def test_cli_resume_after_a_complete_run_drains_everything(config, capsys, tmp_path):
    base = ["--device", "cpu", "--config", config, "--checkpoint-dir", str(tmp_path)]
    serve.main(base)
    first = capsys.readouterr().out
    serve.main([*base, "--resume"])
    second = capsys.readouterr().out
    assert len(_digests(first)) == 5 and _digests(first) == _digests(second)
    assert "chunks_drained=5" in second


def test_cli_sigterm_then_resume(tmp_path):
    """A real SIGTERM after the first chunk's digest: the running chunk is
    finished and journaled, the run exits 0; --resume drains the journaled
    chunks and solves the rest, to the uninterrupted run's digests."""
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
            "--config", "serve-gaussian-fault"]
    ref = subprocess.run([*base, "--checkpoint-dir", str(tmp_path / "ref")], env=_env(),
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    want = _digests(ref.stdout)
    assert len(want) == 5
    d = str(tmp_path / "kill")
    proc = subprocess.Popen([*base, "--checkpoint-dir", d], env=_env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    head = []
    for line in proc.stdout:
        head.append(line)
        if "x_digest=" in line:
            proc.send_signal(signal.SIGTERM)
            break
    rest, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    killed = "".join(head) + rest
    assert "preempted after chunk" in killed, killed
    assert 1 <= len(_digests(killed)) < 5
    assert _digests(killed) == want[:len(_digests(killed))]
    resumed = subprocess.run([*base, "--checkpoint-dir", d, "--resume"], env=_env(), cwd=REPO,
                             capture_output=True, text=True, timeout=300, check=True)
    assert _digests(resumed.stdout) == want
    drained = int(re.search(r"chunks_drained=(\d+)", resumed.stdout).group(1))
    assert drained == len(_digests(killed))
