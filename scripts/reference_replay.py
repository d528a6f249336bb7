#!/usr/bin/env python3
"""Replay an instance saved by ``chip_smoke.py`` through the JAX reference.

``chip_smoke.py`` writes the problems it solved on the GPU, with the port's
answers, as ``.npz`` files. This script runs the reference package
``repro`` (JAX, here on the CPU) on the same inputs and prints its answers
beside the port's, so that a reading of the port can be held against the
reference on identical data:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_replay.py \\
        gaussian chip_smoke_out/gaussian_batch8.npz
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_replay.py \\
        lofar chip_smoke_out/lofar_bench.npz
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_replay.py \\
        lofar-block chip_smoke_out/lofar_bench_block.npz

``gaussian``: the toy batch (Φ, Y, X_true) at bits 4 and 8 through the
reference's packed and fake-quantized (``requantize="fixed"``) ``qniht_batch``
with ``PRNGKey(seed)``. Per row: ‖Δx_b‖/‖x_b‖ between the reference's two
solves (the comparison ``chip_smoke.py`` makes of the port), between the
reference and the port, and each rel_error.

``lofar``: one sky (y, x_true) of a LOFAR CS302 configuration through the
reference's dense NIHT and its packed and fake-fixed QNIHT. Φ is the file's
own when it holds one, else it is rebuilt by the reference's
``measurement_matrix`` (which agrees with the port's to 1e-4).

``lofar-block``: one sky through the reference's packed QNIHT with a
block-scaled Φ̂ (``scale_granularity="per_block"``, the file's
``group_size``), beside the port's answer from the card; Φ as for ``lofar``.

Imports the reference only; nothing of the port.
"""
from __future__ import annotations

import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.lofar_cs302 import BENCH, CONFIG, SMOKE
from repro.core.niht import niht, qniht, qniht_batch
from repro.sensing.telescope import Station, measurement_matrix

LOFAR = {"lofar": CONFIG, "lofar-bench": BENCH, "lofar-smoke": SMOKE}


def _rows(a: np.ndarray, b: np.ndarray) -> list:
    a, b = np.atleast_2d(a), np.atleast_2d(b)
    return (np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)).tolist()


def _total(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def replay_gaussian(d) -> dict:
    phi, Y, X = jnp.asarray(d["phi"]), jnp.asarray(d["Y"]), d["X_true"]
    s, n_iters, bits_y = int(d["s"]), int(d["n_iters"]), int(d["bits_y"])
    key = jax.random.PRNGKey(int(d["seed"]))
    out = {}
    for bits in (4, 8):
        kw = dict(bits_phi=bits, bits_y=bits_y, key=key, requantize="fixed")
        packed = np.asarray(qniht_batch(phi, Y, s, n_iters, backend="packed", **kw).x)
        fake = np.asarray(qniht_batch(phi, Y, s, n_iters, backend="dense", **kw).x)
        port_kernel, port_fake = d[f"x_kernel_bits{bits}"], d[f"x_fake_bits{bits}"]
        out[f"bits={bits}"] = {
            "reference packed vs fake-fixed": {"total": _total(packed, fake),
                                               "rows": _rows(packed, fake)},
            "port packed (kernel) vs fake-fixed": {"total": _total(port_kernel, port_fake),
                                                   "rows": _rows(port_kernel, port_fake)},
            "port vs reference, packed": _rows(port_kernel, packed),
            "port vs reference, fake-fixed": _rows(port_fake, fake),
            "rel_error": {"reference packed": _rows(packed, X),
                          "reference fake-fixed": _rows(fake, X),
                          "port packed": _rows(port_kernel, X),
                          "port fake-fixed": _rows(port_fake, X)},
        }
    return out


def replay_lofar(d, config: str) -> dict:
    cs = LOFAR[config]
    phi, y, x_true = _phi(d, cs), jnp.asarray(d["y"]), d["x_true"]
    kw = dict(real_signal=True, nonneg=True)
    qkw = dict(bits_phi=int(d["bits_phi"]), bits_y=int(d["bits_y"]),
               key=jax.random.PRNGKey(int(d["seed"])), requantize="fixed", **kw)
    ref = {
        "dense": np.asarray(niht(phi, y, cs.n_sources, cs.n_iters, **kw).x),
        "fake-fixed": np.asarray(qniht(phi, y, cs.n_sources, cs.n_iters, backend="dense",
                                       **qkw).x),
        "packed": np.asarray(qniht(phi, y, cs.n_sources, cs.n_iters, backend="packed",
                                   **qkw).x),
    }
    out = {"phi": "from the file" if "phi" in d else "rebuilt by the reference"}
    for name, x in ref.items():
        port = d[f"x_{name.replace('-', '_')}"]
        out[name] = {"reference rel_error": _rows(x, x_true)[0],
                     "port rel_error": _rows(port, x_true)[0],
                     "port vs reference ‖Δx‖/‖x‖": _rows(port, x)[0]}
    return out


def _phi(d, cs):
    """The file's Φ, or the reference's own rebuild of the station's."""
    if "phi" in d:
        return jnp.asarray(d["phi"])
    return measurement_matrix(Station(n_antennas=cs.n_antennas, seed=cs.seed),
                              cs.resolution, cs.extent)


def replay_lofar_block(d, config: str) -> dict:
    cs = LOFAR[config]
    phi, y, x_true = _phi(d, cs), jnp.asarray(d["y"]), d["x_true"]
    x = np.asarray(qniht(phi, y, cs.n_sources, cs.n_iters, bits_phi=int(d["bits_phi"]),
                         bits_y=int(d["bits_y"]), key=jax.random.PRNGKey(int(d["seed"])),
                         requantize="fixed", backend="packed", real_signal=True, nonneg=True,
                         scale_granularity="per_block", group_size=int(d["group_size"])).x)
    port = d["x_packed"]
    return {"phi": "from the file" if "phi" in d else "rebuilt by the reference",
            "group_size": int(d["group_size"]),
            "reference rel_error": _rows(x, x_true)[0],
            "port rel_error": _rows(port, x_true)[0],
            "port vs reference ‖Δx‖/‖x‖": _rows(port, x)[0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("kind", choices=["gaussian", "lofar", "lofar-block"])
    ap.add_argument("npz", help="a file written by chip_smoke.py")
    ap.add_argument("--config", default=None, choices=sorted(LOFAR),
                    help="LOFAR configuration (default: the one named in the file)")
    args = ap.parse_args(argv)
    jax.config.update("jax_threefry_partitionable", True)   # the port's draws
    d = dict(np.load(args.npz))
    if args.kind == "gaussian":
        out = replay_gaussian(d)
    elif args.kind == "lofar-block":
        out = replay_lofar_block(d, args.config or str(d["config"]))
    else:
        out = replay_lofar(d, args.config or str(d["config"]))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
