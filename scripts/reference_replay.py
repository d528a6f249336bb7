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
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_replay.py \\
        lofar --seed 0 --config lofar [--backends packed,dense] [FILE.npz]
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_replay.py \\
        baselines chip_smoke_out/baselines_bench.npz
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_replay.py \\
        baselines --seed 0 --config lofar

``gaussian``: the toy batch (Φ, Y, X_true) at bits 4 and 8 through the
reference's packed and fake-quantized (``requantize="fixed"``) ``qniht_batch``
with ``PRNGKey(seed)``. Per row: ‖Δx_b‖/‖x_b‖ between the reference's two
solves (the comparison ``chip_smoke.py`` makes of the port), between the
reference and the port, and each rel_error.

``lofar``: one sky (y, x_true) of a LOFAR CS302 configuration through the
reference's dense NIHT and its packed and fake-fixed QNIHT. Φ is the file's
own when it holds one, else it is rebuilt by the reference's
``measurement_matrix`` (which agrees with the port's to 1e-4).

With ``--seed S`` in place of (or beside) a file, ``lofar`` draws the sky
itself, as ``repro.launch.recover --config C --seed S`` does (the sky and its
noise from ``PRNGKey(S)``), which is the instance the port's recover solves
for the same seed; ``--backends`` picks the solves. Given a file too, it
checks that the file's sky is that one and compares the port's answers.

``lofar-block``: one sky through the reference's packed QNIHT with a
block-scaled Φ̂ (``scale_granularity="per_block"``, the file's
``group_size``), beside the port's answer from the card; Φ as for ``lofar``.
With ``--seed`` and no file: the sky recover draws, g = 64.

``baselines``: the baselines phase's LOFAR-bench instance (Φ, y, x_true,
the dirty image and beam) through the reference's ``iht``, ``cosamp``,
``fista_l1``, ``clean`` and ``gamma_full`` with the file's iteration counts,
beside the port's answers from the card: rel_error, support recovery,
‖Δx‖/‖x‖ between the two, CLEAN's components and peaks, and γ. With
``--seed S --config C`` and no file it runs them on the instance recover
draws for that seed, with the Fig. 4 and Fig. 9 counts (the reference's own
numbers, for the full-size phase of ``chip_smoke.py``).

Imports the reference only; nothing of the port.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.lofar_cs302 import BENCH, CONFIG, SMOKE
from repro.core import baselines, rip
from repro.core.niht import niht, qniht, qniht_batch
from repro.core.recovery import source_recovery, support_recovery
from repro.sensing.sky import make_sky
from repro.sensing.telescope import Station, measurement_matrix, visibilities

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


def replay_lofar(d, config: str, seed=None, backends=("dense", "fake-fixed", "packed")) -> dict:
    """The reference's solves of one sky: the file's, or with ``seed`` the
    one ``repro.launch.recover`` draws for that seed."""
    cs = LOFAR[config]
    phi = _phi(d or {}, cs)
    drawn = seed is not None
    if drawn:
        y, x_true = _seed_sky(phi, cs, seed)
        bits_phi, bits_y = cs.bits_phi, cs.bits_y
    else:
        y, x_true = jnp.asarray(d["y"]), d["x_true"]
        bits_phi, bits_y, seed = int(d["bits_phi"]), int(d["bits_y"]), int(d["seed"])
    kw = dict(real_signal=True, nonneg=True)
    qkw = dict(bits_phi=bits_phi, bits_y=bits_y, key=jax.random.PRNGKey(seed),
               requantize="fixed", **kw)
    solve = {
        "dense": lambda: niht(phi, y, cs.n_sources, cs.n_iters, **kw),
        "fake-fixed": lambda: qniht(phi, y, cs.n_sources, cs.n_iters, backend="dense", **qkw),
        "packed": lambda: qniht(phi, y, cs.n_sources, cs.n_iters, backend="packed", **qkw),
    }
    out = {"config": config, "seed": seed,
           "phi": "from the file" if d and "phi" in d else "rebuilt by the reference"}
    if d and drawn and "x_true" in d:
        out["file holds this seed's sky"] = bool(np.array_equal(d["x_true"], x_true))
    for name in backends:
        x = np.asarray(solve[name]().x)
        out[name] = {"reference rel_error": _rows(x, x_true)[0],
                     "reference support_recovery": float(support_recovery(
                         jnp.asarray(x), jnp.asarray(x_true), cs.n_sources))}
        port = (d or {}).get(f"x_{name.replace('-', '_')}")
        if port is not None:
            out[name].update({"port rel_error": _rows(port, x_true)[0],
                              "port vs reference ‖Δx‖/‖x‖": _rows(port, x)[0]})
    return out


# benchmarks/fig4_methods.py's counts at the LOFAR CS302 config's 60 iterations, and
# benchmarks/fig9_clean.py's CLEAN
FIG4_ITERS = {"iht": 120, "cosamp": 20, "fista_l1": 180}
FIG9_CLEAN = {"clean_gain": 0.1, "n_iters_clean": 300}


def seed_instance(config: str, seed: int) -> dict:
    """The instance ``repro.launch.recover --config C --seed S`` solves, with
    its dirty image and beam and the figures' iteration counts."""
    cs = LOFAR[config]
    phi = _phi({}, cs)
    y, x = _seed_sky(phi, cs, seed)
    from repro.sensing.telescope import dirty_beam, dirty_image

    d = {"phi": phi, "y": y, "x_true": x, "s": cs.n_sources,
         "dirty_image": dirty_image(phi, y, cs.resolution),
         "dirty_beam": dirty_beam(phi, cs.resolution), **FIG9_CLEAN}
    d.update({f"n_iters_{k}": v for k, v in FIG4_ITERS.items()})
    return d


def replay_baselines(d) -> dict:
    """The reference's baselines and γ on the file's instance, beside the
    port's answers where the file holds them."""
    phi, y, x_true = jnp.asarray(d["phi"]), jnp.asarray(d["y"]), d["x_true"]
    s = int(d["s"])
    out = {"gamma_full": {"reference": float(rip.gamma_full(phi)),
                          "port": float(d["gamma_full"]) if "gamma_full" in d else None}}
    runs = {
        "iht": lambda n: baselines.iht(phi, y, s, n, real_signal=True),
        "cosamp": lambda n: baselines.cosamp(phi, y, s, n, real_signal=True),
        "fista_l1": lambda n: baselines.fista_l1(phi, y, n_iters=n, real_signal=True),
    }
    for name, run in runs.items():
        n = int(d[f"n_iters_{name}"])
        t0 = time.perf_counter()
        x, resid = run(n)
        x = np.asarray(x)
        wall = time.perf_counter() - t0
        out[name] = {
            "reference rel_error": _rows(x, x_true)[0],
            "reference support_recovery": float(support_recovery(jnp.asarray(x),
                                                                 jnp.asarray(x_true), s)),
            "reference µs per iteration (compile included)": wall * 1e6 / n,
            "reference resid last": float(np.asarray(resid)[-1]),
        }
        port = d.get(f"x_{name}")
        if port is not None:
            out[name].update({"port rel_error": _rows(port, x_true)[0],
                              "port vs reference ‖Δx‖/‖x‖": _rows(port, x)[0],
                              "same support": bool(np.array_equal(port != 0, x != 0)),
                              "port resid last": float(d[f"resid_{name}"][-1])})
    comps, resid, peaks = baselines.clean(jnp.asarray(d["dirty_image"]),
                                          jnp.asarray(d["dirty_beam"]),
                                          float(d["clean_gain"]), int(d["n_iters_clean"]))
    comps, r = np.asarray(comps), int(np.sqrt(x_true.size))
    out["clean"] = {"components": int((comps != 0).sum()),
                    "source_recovery": float(source_recovery(
                        jnp.asarray(comps), jnp.asarray(x_true).reshape(r, r), s, 1)),
                    "last peak": float(np.asarray(peaks)[-1])}
    if "comps_clean" in d:
        out["clean"].update({
            "same positions as the port": bool(np.array_equal(comps != 0,
                                                              d["comps_clean"] != 0)),
            "components max |Δ|": float(np.abs(comps - d["comps_clean"]).max()),
            "peaks max |Δ|": float(np.abs(np.asarray(peaks) - d["peaks_clean"]).max()),
            "port last peak": float(d["peaks_clean"][-1])})
    return out


def _seed_sky(phi, cs, seed):
    """(y, x_true) as ``repro.launch.recover`` draws them for ``seed``: the
    sky and its noise from ``PRNGKey(seed)``."""
    key = jax.random.PRNGKey(seed)
    x = make_sky(cs.resolution, cs.n_sources, key, min_sep=cs.min_sep)
    return visibilities(phi, x, cs.snr_db, key)[0], np.asarray(x)


def _phi(d, cs):
    """The file's Φ, or the reference's own rebuild of the station's."""
    if "phi" in d:
        return jnp.asarray(d["phi"])
    return measurement_matrix(Station(n_antennas=cs.n_antennas, seed=cs.seed),
                              cs.resolution, cs.extent)


def replay_lofar_block(d, config: str, seed=None, group_size=64) -> dict:
    """The reference's per_block packed solve of the file's sky, or with
    ``seed`` (and no file) of the sky recover draws for it."""
    cs = LOFAR[config]
    if d is None:
        phi = _phi({}, cs)
        y, x_true = _seed_sky(phi, cs, seed)
        d = {"bits_phi": cs.bits_phi, "bits_y": cs.bits_y, "seed": seed,
             "group_size": group_size}
    else:
        phi, y, x_true = _phi(d, cs), jnp.asarray(d["y"]), d["x_true"]
    x = np.asarray(qniht(phi, y, cs.n_sources, cs.n_iters, bits_phi=int(d["bits_phi"]),
                         bits_y=int(d["bits_y"]), key=jax.random.PRNGKey(int(d["seed"])),
                         requantize="fixed", backend="packed", real_signal=True, nonneg=True,
                         scale_granularity="per_block", group_size=int(d["group_size"])).x)
    out = {"phi": "from the file" if "phi" in d else "rebuilt by the reference",
           "group_size": int(d["group_size"]),
           "reference rel_error": _rows(x, x_true)[0]}
    if "x_packed" in d:
        out.update({"port rel_error": _rows(d["x_packed"], x_true)[0],
                    "port vs reference ‖Δx‖/‖x‖": _rows(d["x_packed"], x)[0]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("kind", choices=["gaussian", "lofar", "lofar-block", "baselines"])
    ap.add_argument("npz", nargs="?", help="a file written by chip_smoke.py")
    ap.add_argument("--config", default=None, choices=sorted(LOFAR),
                    help="LOFAR configuration (default: the one named in the file)")
    ap.add_argument("--seed", type=int, default=None,
                    help="(lofar, lofar-block, baselines) draw the sky repro.launch.recover "
                         "draws for this seed instead of reading a file")
    ap.add_argument("--backends", default="dense,fake-fixed,packed",
                    help="(lofar) comma-separated solves: dense, fake-fixed, packed")
    args = ap.parse_intermixed_args(argv)
    if args.npz is None and not (args.kind != "gaussian" and args.seed is not None):
        ap.error("give a file, or for lofar, lofar-block and baselines --seed")
    jax.config.update("jax_threefry_partitionable", True)   # the port's draws
    d = dict(np.load(args.npz)) if args.npz else None
    if args.kind == "gaussian":
        out = replay_gaussian(d)
    elif args.kind == "lofar-block":
        out = replay_lofar_block(d, args.config or (str(d["config"]) if d else "lofar"),
                                 args.seed)
    elif args.kind == "baselines":
        out = replay_baselines(d if d is not None
                               else seed_instance(args.config or "lofar", args.seed))
    else:
        out = replay_lofar(d, args.config or (str(d["config"]) if d else "lofar"), args.seed,
                           tuple(args.backends.split(",")))
    print(json.dumps(out, indent=1, ensure_ascii=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
