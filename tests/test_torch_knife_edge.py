"""``chip_smoke.py``'s knife-edge witness for the serve phase, on the CPU.

The witness lets a served request part from the JAX reference's rel_error
only on positive evidence that rounding decides it. Here a faithful stand-in
for the card (the port's CPU itself) gives no witness, a stand-in whose Φ̂
scale is off by 1e-3 breaks the bound of exact arithmetic, and a stand-in
that sums in another order (the dequantized float32 Φ̂ through a dense
product) parts from the CPU at an exact tie of Cᵀq at the first pick of
``serve-continuous-packed`` request 63.
"""
import copy
import dataclasses
import importlib
import runpy
from pathlib import Path

import pytest
import torch

from repro_torch import parallel
from repro_torch import random as prng
from repro_torch.configs import SERVE_CONFIGS
from repro_torch.core.operators import PackedStreamingOperator
from repro_torch.launch import serve
from repro_torch.quant.formats import BY_BITS
from repro_torch.quant.pack import unpack_codes

niht = importlib.import_module("repro_torch.core.niht")   # the module: the package exports the function niht

SMOKE = runpy.run_path(str(Path(__file__).resolve().parents[1] / "chip_smoke.py"),
                       run_name="chip_smoke_witness")
MODS = dict(niht=niht, prng=prng, unpack_codes=unpack_codes, BY_BITS=BY_BITS,
            PackedStreamingOperator=PackedStreamingOperator)


def _scheduler(cfg):
    phi, arrivals, _, _ = serve.build_requests(cfg, prng.PRNGKey(cfg.seed), "cpu")
    sch = parallel.ContinuousScheduler(
        phi, cfg.s, cfg.n_iters, slots=cfg.slots, seg_len=cfg.seg_len,
        key=prng.PRNGKey(cfg.seed), exit_tol=cfg.exit_tol,
        **serve._solver_kwargs(cfg))
    return sch, {req.rid: req for _, req in arrivals}


@pytest.fixture(scope="module")
def smoke():
    # the smoke stream on a packed Φ̂ under the lossless exit, as the packed config
    cfg = dataclasses.replace(SERVE_CONFIGS["serve-continuous-smoke"], bits_phi=4, bits_y=8,
                              backend="packed", exit_tol=0.0)
    return _scheduler(cfg)


def _witness(sch, req):
    return SMOKE["knife_edge_witness"](torch, MODS, sch, req.y, req.n_iters or sch.n_iters)


@pytest.mark.parametrize("rid", [0, 7])
def test_a_faithful_card_gives_no_witness(smoke, rid):
    sch, requests = smoke
    w = _witness(sch, requests[rid])
    assert not w["knife_edge"]
    assert w["reason"] == "from the card's states the CPU keeps the card's support"
    assert w["card_bound_ratio"] <= 1.0


@pytest.mark.parametrize("rid", [0, 7])
def test_a_scale_fault_breaks_the_bound(smoke, rid):
    sch, requests = smoke
    faulty = copy.copy(sch)
    faulty.phi = copy.deepcopy(sch.phi)
    for w in (faulty.phi.packed.fwd_re, faulty.phi.packed.adj_re):
        w.scale.mul_(1.001)
    w = _witness(faulty, requests[rid])
    assert not w["knife_edge"] and w["iteration"] == 0
    assert w["reason"] == "the card's step leaves the bound of exact arithmetic"
    assert w["card_bound_ratio"] > 1.0


def test_another_summation_order_parts_at_an_exact_tie():
    sch, requests = _scheduler(SERVE_CONFIGS["serve-continuous-packed"])
    w = sch.phi.packed.fwd_re
    dense = copy.copy(sch)
    dense.phi = unpack_codes(w.packed, w.bits, w.k_dim).to(torch.float32) * (
        w.scale.reshape(-1, 1) / BY_BITS[w.bits].half_steps)
    got = _witness(dense, requests[63])
    assert got["knife_edge"] and got["iteration"] == 0 and got["round"] == 0
    assert got["exact_gap"] < 1e-6 * got["magnitude"] < got["allowed_gap"]
    assert got["card_bound_ratio"] < 0.05 and got["cpu_bound_ratio"] < 0.05
