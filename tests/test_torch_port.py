"""Boundaries of the port: it imports neither JAX nor the JAX package, its
entry points run on the GPU unless asked for the CPU, and its recover CLI
reproduces the README quickstart's bound on the CPU."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.launch import recover

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SMOKE = REPO / "chip_smoke.py"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return env


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PORT)], prefix="repro_torch."))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top == "jax" or top.startswith("jax") or top == "jaxlib" or top == "repro"


def test_importing_the_port_loads_no_jax_and_no_reference():
    mods = _port_modules()
    assert "repro_torch.kernels.qmm.kernel" in mods and "repro_torch.launch.recover" in mods
    code = (
        "import sys, importlib, runpy\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"ns = runpy.run_path({str(SMOKE)!r}, run_name='chip_smoke_imports')\n"
        "ns['load_port']()\n"
        "print('\\n'.join(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_env(), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = out.stdout.split()
    assert "torch" in loaded and "repro_torch.core.niht" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in
                                        [*PORT.rglob("*.py"), SMOKE]))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not [n for n in names if _forbidden(n)], (path, node.lineno, names)


def test_cuda_is_the_default_device_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.device import resolve_device
    from repro_torch.sensing.gaussian import make_gaussian_problem

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        make_gaussian_problem(8, 16, 2)
    with pytest.raises(RuntimeError):
        recover.main(["--config", "gaussian-smoke", "--backend", "packed"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_recover_cli_gaussian_smoke_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.recover", "--config", "gaussian-smoke",
         "--backend", "packed", "--bits-phi", "8", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[recover] gaussian-smoke 8&8bit[packed]: rel_error=")
    rel = float(line.split("rel_error=")[1].split()[0])
    assert rel < 0.15


def test_recover_cli_default_device_fails_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU; the CPU-only failure cannot show here")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.recover", "--config", "gaussian-smoke"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=120)
    assert out.returncode != 0 and "torch.cuda.is_available() is False" in out.stderr
    assert "[recover]" not in out.stdout


@pytest.mark.parametrize("argv", [["--devices", "2"]])
def test_recover_rejects_unported_options(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        recover.main(["--device", "cpu", *argv])
    assert exc.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_recover_lofar_smoke_batch_on_cpu():
    from repro_torch.configs.lofar_cs302 import SMOKE as LOFAR_SMOKE

    out, res, x_true = recover.recover_lofar(LOFAR_SMOKE, "packed", 2, 8, seed=1, batch=2,
                                             device="cpu")
    assert res.x.shape == x_true.shape == (2, 1024)
    assert out["rel_error_max"] < 0.5 and res.trace.resid_q.shape == (LOFAR_SMOKE.n_iters, 2)


@pytest.mark.parametrize("batch", [0, 2])
def test_lofar_instance_is_the_sky_recover_solves(batch):
    from repro_torch.configs.lofar_cs302 import SMOKE as LOFAR_SMOKE

    phi, y, x = recover.lofar_instance(LOFAR_SMOKE, 3, batch, "cpu")
    _, res, x_true = recover.recover_lofar(LOFAR_SMOKE, "dense", None, None, seed=3,
                                           batch=batch, device="cpu")
    assert torch.equal(x, x_true) and phi.shape == (870, 1024)
    assert y.shape == ((batch, 870) if batch else (870,)) and res.x.shape == x.shape


def test_gaussian_batch_instance_is_the_batch_recover_solves():
    from repro_torch.configs.gaussian_toy import SMOKE as GAUSS_SMOKE

    phi, Y, X = recover.gaussian_batch_instance(GAUSS_SMOKE, 2, 3, "cpu")
    _, res, x_true = recover.recover_gaussian(GAUSS_SMOKE, "packed", 8, 8, seed=2,
                                              requantize="fixed", batch=3, device="cpu")
    assert torch.equal(X, x_true) and Y.shape == (3, GAUSS_SMOKE.m)
    assert phi.shape == (GAUSS_SMOKE.m, GAUSS_SMOKE.n) and res.x.shape == X.shape


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, str(SMOKE)], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    out = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_package_docstring_names_the_default():
    assert "cuda" in repro_torch.__doc__
