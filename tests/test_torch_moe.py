"""repro_torch.models' MoE family (qwen3-moe: the mixture of SwiGLU experts
of models/moe.py) against repro.models on the CPU.

The SMOKE configs: qwen3-moe-30b (2 layers, d = 64, 8 experts of d_ff 32,
top-2) and qwen3-moe-235b (3 layers, head dim 8); B = 2. A prompt of 16
tokens and 4 decode steps: ``forward`` routes its 40 tokens as one group
(capacity 12), the prefill its 32 (capacity 10), a decode step its 2 tokens
(capacity 1, so picks of one expert by both tokens drop one). ``moe_apply``
alone: one group, three groups with a padded last one, a capacity that
drops picks, zero rows whose tied probabilities go to the lower experts, a
W4 tree, and one group in bfloat16.

Tolerances: initial weights within 1e-6 (the port's threefry normals differ
from JAX's only in the order of the erfinv polynomial's float operations),
their uniform words bit for bit; ``moe_apply``'s output and load loss, and
the logits, in float32 within 1e-5 of max|reference| (the port sums each
token's picks in pick order, the reference over experts in index order);
in bfloat16 within 2e-2 (bfloat16 rounds at other places in the two
packages), except the logits of a bfloat16 model: the two packages' residual
streams part by bfloat16 roundings, which can swap two experts whose router
probabilities nearly tie, and a swapped pick moves that token's FFN output
by a whole expert's share. Those logits are held within 2e-2 at 90% of the
positions and within 5e-2 at every one (qwen3-moe-235b SMOKE: 0.032 at 2 of
40 forward positions). The loss and every gradient leaf within 1e-5 (of
max|g| per leaf). Codes and scales bit for bit. Each reference function is
compiled once per case.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import quantized as jq
from repro.quant.policy import QuantPolicy as JPolicy
from repro_torch import configs as tconfigs
from repro_torch import random as prng
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import (
    decode_step,
    forward,
    generate,
    init_cache,
    init_params,
    init_quantized_params,
    loss_fn,
    prefill,
    quantize_params,
)
from repro_torch.models import moe as tmoe
from repro_torch.models.quantized import QWeight
from repro_torch.quant.policy import QuantPolicy
from torch_threads import one_torch_thread  # noqa: F401 -- autouse: one intra-op thread


@pytest.fixture(autouse=True, scope="module")
def _leave_no_jax_executables():
    """Drop the JAX executables this module's reference calls compiled: an
    eager primitive cached with jax_debug_nans off would keep later tests in
    the process (tests/test_sanitize.py) from tripping."""
    yield
    jax.clear_caches()


ARCHS = ("qwen3_moe_30b", "qwen3_moe_235b")
B = 2
PROMPT, STEPS = 16, 4
T = PROMPT + STEPS
INIT_TOL = 1e-6
F32_TOL = 1e-5
BF16_TOL = 2e-2
BF16_ROUTED_TOL, BF16_ROUTED_SHARE = 5e-2, 0.1   # a bf16 model's logits (see above)
D, FF, E, K = 64, 32, 8, 2          # qwen3_moe_30b SMOKE's width, experts and top-k


def _cfgs(arch, dtype="float32", **replace):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), dtype=dtype, **replace),
            dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype, **replace))


def _j(a):
    a = np.asarray(a)
    return jnp.asarray(a, dtype=a.dtype)


def _numpy_tree(tree):
    """numpy leaves in the tree's own order of keys; a QWeight as a
    namespace of its arrays."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if isinstance(tree, jq.QWeight):
        return types.SimpleNamespace(packed=np.asarray(tree.packed),
                                     scale=np.asarray(tree.scale), bits=tree.bits,
                                     k_dim=tree.k_dim)
    return np.asarray(tree)


def _paths(tree, pre=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, pre + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, pre + (i,))]
    return [(pre, tree)]


# nearest W4 codes of a reference tree (no key: jit may sort the keys)
_QUANTIZE_W4 = jax.jit(lambda p: jq.quantize_params(p, 4))


def _close(name, got, want, tol, scale=None):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{name}: max |Δ| / max|reference| = {err:.3g} > {tol}"


def _close_logits(name, got, want, tol, scale):
    """Logits (..., V) within ``tol`` of ``scale`` at every position, or, for
    a bfloat16 model (tol = BF16_TOL), within it at all but BF16_ROUTED_SHARE
    of the positions and within BF16_ROUTED_TOL at every one. Returns the
    per-position gaps."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all(), name
    gaps = np.abs(got - want).max(-1) / scale
    if tol < BF16_TOL:
        assert gaps.max() <= tol, f"{name}: max |Δ| / max|reference| = {gaps.max():.3g} > {tol}"
        return gaps
    share = float((gaps > tol).mean())
    assert gaps.max() <= BF16_ROUTED_TOL and share <= BF16_ROUTED_SHARE, (
        f"{name}: max |Δ| / max|reference| = {gaps.max():.3g} (limit {BF16_ROUTED_TOL}), "
        f"{share:.0%} of the positions past {tol} (limit {BF16_ROUTED_SHARE:.0%})")
    return gaps


@pytest.fixture(scope="module")
def reference_params():
    """The reference's parameters of each arch from PRNGKey(0), float32."""
    with jax.threefry_partitionable(True):
        return {arch: jmodel.init_params(_cfgs(arch)[0], jax.random.PRNGKey(0))
                for arch in ARCHS}


def test_moe_init_is_the_reference_draw():
    """The router (dense_init) and the three expert stacks within 1e-6, the
    uniform words under each stack's normals bit for bit."""
    with jax.threefry_partitionable(True):
        want = jmoe.moe_init(jax.random.PRNGKey(3), D, FF, E)
        keys = jax.random.split(jax.random.PRNGKey(3), 4)
        words = [np.asarray(jax.random.bits(keys[i], (E, D, FF) if i < 3 else (E, FF, D)))
                 for i in (1, 2, 3)]
    got = tmoe.moe_init(prng.PRNGKey(3), D, FF, E, device="cpu")
    assert list(got) == ["router", "wi_gate", "wi_up", "wo"] and list(got["router"]) == ["w"]
    tkeys = prng.split(prng.PRNGKey(3), 4)
    for i, w in zip((1, 2, 3), words):
        shape = (E, D, FF) if i < 3 else (E, FF, D)
        np.testing.assert_array_equal(prng.bits(tkeys[i], shape, device="cpu").numpy()
                                      .astype(np.uint32), w)
    for name, a, b in (("router", want["router"]["w"], got["router"]["w"]),
                       ("wi_gate", want["wi_gate"], got["wi_gate"]),
                       ("wi_up", want["wi_up"], got["wi_up"]), ("wo", want["wo"], got["wo"])):
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=INIT_TOL, err_msg=name)


@pytest.fixture(scope="module")
def layer_params():
    """moe_init's draw from PRNGKey(1): the reference's float32 tree and its
    W4 codes (nearest), and the port's of the same arrays."""
    with jax.threefry_partitionable(True):
        pj = jmoe.moe_init(jax.random.PRNGKey(1), D, FF, E)
    qj = _QUANTIZE_W4(pj)
    return {None: (pj, lm_params_from_numpy(_numpy_tree(pj), "cpu")),
            4: (qj, lm_params_from_numpy(_numpy_tree(qj), "cpu"))}


def _x(seed, shape, zero_rows=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[0, :zero_rows] = 0.0
    return x


# name: (x shape, zero rows, group size, capacity factor, weight bits, dtype, tolerance)
APPLY_CASES = {
    "one_group": ((2, 16, D), 0, 4096, 1.25, None, "float32", F32_TOL),
    "groups_padded": ((2, 16, D), 0, 12, 1.25, None, "float32", F32_TOL),
    "capacity_drops": ((2, 16, D), 0, 4096, 0.5, None, "float32", F32_TOL),
    "router_ties": ((2, 16, D), 6, 4096, 1.25, None, "float32", F32_TOL),
    "w4": ((2, 16, D), 0, 12, 1.25, 4, "float32", F32_TOL),
    "bfloat16": ((2, 16, D), 0, 4096, 1.25, None, "bfloat16", BF16_TOL),
}


@pytest.mark.parametrize("case", list(APPLY_CASES))
def test_moe_apply(layer_params, case):
    """The block's output and load loss against the reference's moe_apply
    (jitted) on the same inputs; where the case is about it, the port's
    routing shows it: picks dropped, zero rows' tied picks on experts 0 and
    1, three groups from 32 tokens in groups of 12."""
    shape, zeros, group, cf, bits, dtype, tol = APPLY_CASES[case]
    pj, pt = layer_params[bits]
    x = _x(len(case), shape, zeros)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    apply = jax.jit(functools.partial(jmoe.moe_apply, top_k=K, capacity_factor=cf,
                                      group_size=group))
    want_y, want_aux = apply(pj, _j(x).astype(jdt))
    got_y, got_aux = tmoe.moe_apply(pt, torch.from_numpy(x).to(tdt), top_k=K,
                                    capacity_factor=cf, group_size=group)
    assert got_y.dtype == tdt and tuple(got_y.shape) == shape
    _close(f"{case} y", got_y.float().numpy(), np.asarray(want_y, np.float32), tol)
    _close(f"{case} load loss", float(got_aux["moe_load_loss"]),
           float(want_aux["moe_load_loss"]), tol)
    g = min(group, shape[0] * shape[1])
    cap = max(1, int(g * K / E * cf))
    xg = torch.from_numpy(x).reshape(-1, D)[:g]
    _, _, idx = tmoe.route(xg, pt["router"]["w"], K)
    _, kept, _ = tmoe.slots(idx, E, cap)
    if case == "capacity_drops":
        assert cap == 4 and int(kept.sum()) < g * K
    if case == "router_ties":
        assert idx[:zeros].tolist() == [[0, 1]] * zeros
    if case == "groups_padded":
        assert -(-shape[0] * shape[1] // group) == 3


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)


def _reference_run(cfg, params, tokens, bits):
    """forward over the T tokens and the prefill of PROMPT in one jit, the
    decode step (teacher-forced on tokens[:, PROMPT + i]) in another."""
    policy = JPolicy(weight_bits=bits[0], kv_bits=bits[1])

    def fwd_and_prefill(p, t):
        return jmodel.forward(cfg, p, t, policy=policy), jmodel.prefill(
            cfg, p, t[:, :PROMPT], jmodel.init_cache(cfg, B, T + 8, policy), policy=policy)
    dec = jax.jit(lambda p, t, c, pos: jmodel.decode_step(cfg, p, t, c, policy=policy,
                                                          position=pos))
    fwd_and_prefill = jax.jit(fwd_and_prefill)
    (full, aux), (logits, cache) = fwd_and_prefill(params, _j(tokens))
    out = {"forward": np.asarray(full, np.float32), "load": float(aux["moe_load_loss"]),
           "prefill": np.asarray(logits, np.float32), "steps": []}
    for i in range(STEPS):
        ld, cache = dec(params, _j(tokens[:, PROMPT + i]), cache,
                        jnp.asarray(PROMPT + i, jnp.int32))
        out["steps"].append(np.asarray(ld, np.float32))
    return out


# (dtype, (weight bits, kv bits), tolerance) of each case
CASES = {"float32": ("float32", (None, None), F32_TOL),
         "float32_w4kv8": ("float32", (4, 8), F32_TOL),
         "bfloat16_w4kv8": ("bfloat16", (4, 8), BF16_TOL)}


@pytest.mark.parametrize("arch,case", [(arch, case) for arch in ARCHS for case in CASES
                                       if arch == ARCHS[0] or case != "float32_w4kv8"])
def test_logits_and_generate(reference_params, arch, case):
    """forward (and its load loss), the prefill and four decode steps against
    the reference's, on the tokens the port's generate took; each of those
    tokens is the argmax of the reference's own logits wherever its top two
    stand further apart than twice the two packages' gap there."""
    dtype, bits, tol = CASES[case]
    cfg_j, cfg_t = _cfgs(arch, dtype)
    pj = reference_params[arch]
    if bits[0]:
        pj = _QUANTIZE_W4(pj)
    pt = lm_params_from_numpy(_numpy_tree(pj), "cpu")
    policy = QuantPolicy(weight_bits=bits[0], kv_bits=bits[1])
    prompt = torch.from_numpy(_tokens(cfg_t)).long()
    toks, glogits = generate(cfg_t, pt, prompt, STEPS + 1, policy)
    tokens = torch.cat([prompt, toks[:, :STEPS]], 1).to(torch.int32)
    want = _reference_run(cfg_j, pj, tokens.numpy(), bits)
    scale = float(np.abs(want["forward"]).max())
    full, aux = forward(cfg_t, pt, tokens, policy=policy)
    _close_logits("forward", full.float().numpy(), want["forward"], tol, scale)
    _close("load loss", float(aux["moe_load_loss"]), want["load"], tol)
    cache = init_cache(cfg_t, B, T + 8, policy, device="cpu")
    logits, cache = prefill(cfg_t, pt, tokens[:, :PROMPT], cache, policy=policy)
    served = [logits]
    for i in range(STEPS):
        ld, cache = decode_step(cfg_t, pt, tokens[:, PROMPT + i], cache, policy=policy)
        served.append(ld)
    ref = np.stack([want["prefill"]] + want["steps"], 1)          # (B, STEPS + 1, V)
    _close_logits("prefill and decode steps", torch.stack(served, 1).float().numpy(), ref, tol,
                  scale)
    gaps = _close_logits("generate's logits", glogits.float().numpy(), ref, tol, scale)
    top2 = np.sort(ref, -1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > 2 * gaps * scale
    assert decided.any()
    assert (toks.numpy() == ref.argmax(-1))[decided].all()


def _port_value_and_grad(cfg, params_np, tokens, labels):
    params = lm_params_from_numpy(params_np, "cpu")
    leaves = [leaf for _, leaf in _paths(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(cfg, params, {"tokens": torch.from_numpy(tokens),
                                 "labels": torch.from_numpy(labels)})
    loss.backward()
    return float(loss.detach()), [p.grad.float().numpy() for p in leaves]


@pytest.mark.parametrize("group", [4096, 12], ids=["one_group", "groups_remat"])
def test_loss_fn_and_gradients(reference_params, group):
    """loss_fn with its load term (0.01·moe_load_loss/n_layers) and every
    gradient leaf against jax.value_and_grad of the reference's, float32,
    qwen3-moe-30b SMOKE on 2 × 16 tokens: one group, and groups of 12 (three
    a layer, the last padded), each checkpointed in the port."""
    cfg_j, cfg_t = _cfgs("qwen3_moe_30b", moe_group_size=group)
    pj = reference_params["qwen3_moe_30b"]
    toks = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (B, PROMPT + 1))
    tokens, labels = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
    labels[1, -3:] = -1                                             # padding labels
    value_and_grad = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(cfg_j, p, b)))
    want, grads = value_and_grad(pj, {"tokens": _j(tokens), "labels": _j(labels)})
    load_loss = jax.jit(lambda p, t: jmodel.forward(cfg_j, p, t)[1]["moe_load_loss"])
    load = load_loss(pj, _j(tokens))
    assert float(load) > 0
    loss, got = _port_value_and_grad(cfg_t, _numpy_tree(pj), tokens, labels)
    assert abs(loss - float(want)) <= F32_TOL * abs(float(want))
    want_grads = {path: np.asarray(a) for path, a in _paths(grads)}    # jit sorts the keys
    paths = [p for p, _ in _paths(_numpy_tree(pj))]
    assert sorted(paths) == sorted(want_grads)
    for path, g in zip(paths, got):
        w = want_grads[path]
        _close(f"grad {path}", g, w, F32_TOL, max(float(np.abs(w).max()), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_quantized_params_is_quantize_of_init(arch):
    """The W4 tree built leaf by leaf is quantize_params(init_params(...))
    bit for bit: every key, code and scale, and the dense leaves."""
    cfg = _cfgs(arch)[1]
    want = quantize_params(init_params(cfg, prng.PRNGKey(0), device="cpu"), 4)
    got = init_quantized_params(cfg, prng.PRNGKey(0), 4, device="cpu")
    lw, lg = _paths(want), _paths(got)
    assert [p for p, _ in lg] == [p for p, _ in lw]
    for (path, a), (_, b) in zip(lw, lg):
        if isinstance(a, QWeight):
            assert isinstance(b, QWeight) and (a.bits, a.k_dim) == (b.bits, b.k_dim), path
            assert torch.equal(a.packed, b.packed) and torch.equal(a.scale, b.scale), path
        else:
            assert torch.equal(a, b), path
    assert got["slots"]["slot0"]["ffn"]["wi_gate"].packed.shape == (cfg.n_layers, E, FF, D // 2)
    with pytest.raises(TypeError, match="stochastic"):
        init_quantized_params(cfg, prng.PRNGKey(0), 4, device="cpu", stochastic=True)


def test_convert_takes_the_reference_moe_tree(reference_params):
    """The reference's float32 tree (its (L, E, d, ff) expert stacks) is the
    port's init within 1e-6 once converted, and the reference's W4 tree of
    it, converted, is the port's quantize_params of the converted float32
    tree bit for bit ((L, E, ff, d/2) codes, (L, E, ff, 1) scales)."""
    pj = reference_params["qwen3_moe_30b"]
    ft = lm_params_from_numpy(_numpy_tree(pj), "cpu")
    own = init_params(_cfgs("qwen3_moe_30b")[1], prng.PRNGKey(0), device="cpu")
    lf, lo = _paths(ft), _paths(own)
    assert [p for p, _ in lf] == [p for p, _ in lo]
    for (path, a), (_, b) in zip(lf, lo):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=INIT_TOL, err_msg=str(path))
    qt = lm_params_from_numpy(_numpy_tree(_QUANTIZE_W4(pj)), "cpu")
    mine = dict(_paths(quantize_params(ft, 4)))          # jit sorts the keys of its output
    assert sorted(mine) == sorted(p for p, _ in _paths(qt))
    for path, a in _paths(qt):
        b = mine[path]
        if isinstance(a, QWeight):
            assert torch.equal(a.packed, b.packed) and torch.equal(a.scale, b.scale), path
        else:
            assert torch.equal(a, b), path
    wo = qt["slots"]["slot0"]["ffn"]["wo"]
    assert isinstance(wo, QWeight) and wo.packed.shape == (2, E, D, FF // 2)
    assert wo.scale.shape == (2, E, D, 1)


def test_batched_qmm_on_the_cpu_is_the_plain_version():
    """qmm_batched on CPU tensors runs qmm_batched_ref, which is qmm_ref of
    each expert, and launches nothing; the kernel refuses CPU tensors."""
    from repro_torch.kernels.qmm import kernel as qmm_kernel
    from repro_torch.kernels.qmm.ops import qmm_batched
    from repro_torch.kernels.qmm.ref import qmm_ref
    from repro_torch.models.quantized import quantize_weight

    gen = torch.Generator().manual_seed(7)
    qw = quantize_weight(torch.randn(3, 40, 24, generator=gen), 4)
    x = torch.randn(3, 5, 40, generator=gen)
    before = qmm_kernel.QMM_BATCHED.launches
    y = qmm_batched(x, qw.packed, qw.scale, 4, 40)
    assert qmm_kernel.QMM_BATCHED.launches == before and y.shape == (3, 5, 24)
    for e in range(3):
        want = qmm_ref(x[e], qw.packed[e], qw.scale[e].reshape(1, -1), 4, 40)
        torch.testing.assert_close(y[e], want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel.QMM_BATCHED(x, qw.packed, qw.scale, 4, 40)



@pytest.mark.parametrize("case", ["one_group", "capacity_drops", "router_ties"])
def test_slots_rows_are_each_experts_kept_picks(layer_params, case):
    """``slots``' rows (the expert products' rows in use) are each expert's
    kept picks on the reference's group: the sum of its one-hot dispatch
    tensor (transcribed from src/repro/models/moe.py:46-53) over tokens and
    slots; the port's xe equals the reference's, and its rows past them are
    zero, so the kernel route may skip them."""
    shape, zeros, group, cf, _, _, _ = APPLY_CASES[case]
    pj, pt = layer_params[None]
    x = _x(len(case), shape, zeros)
    g = min(group, shape[0] * shape[1])
    cap = max(1, int(g * K / E * cf))
    xg = x.reshape(-1, D)[:g]
    probs = jax.nn.softmax(_j(xg) @ pj["router"]["w"], axis=-1)
    onehot = jax.nn.one_hot(jax.lax.top_k(probs, K)[1], E, dtype=jnp.int32)
    flat = onehot.reshape(g * K, E)
    pos = (jnp.cumsum(flat, axis=0) * flat - 1).reshape(g, K, E)
    keep = ((pos >= 0) & (pos < cap))[..., None].astype(jnp.float32) * onehot[..., None]
    disp = jnp.sum(jax.nn.one_hot(jnp.clip(pos, 0, cap - 1), cap) * keep, axis=1)  # (g, E, C)
    xe, route = tmoe.dispatch(torch.from_numpy(xg), pt["router"]["w"], top_k=K, n_experts=E,
                              cap=cap, dtype=torch.float32)
    rows = route[5]
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (E,)
    assert rows.tolist() == np.asarray(disp.sum((0, 2))).astype(int).tolist()
    assert int(rows.sum()) == int(route[4].sum())                   # kept picks
    np.testing.assert_array_equal(xe.numpy(), np.asarray(jnp.einsum("td,tec->ecd", _j(xg), disp)))
    in_use = torch.arange(cap) < rows[:, None]
    assert bool((xe[~in_use] == 0).all())
    if case == "capacity_drops":
        assert int(rows.max()) == cap and int(rows.sum()) < g * K


def test_batched_ref_with_rows_is_the_product_at_the_rows_in_use():
    """qmm_batched_ref with ``rows`` is the full product at each expert's rows
    in use and 0 past them (rows past C take them all), whatever x holds
    there; on x whose rows past ``rows`` are zero it equals the full
    product; qmm_batched on CPU tensors runs it and launches nothing."""
    from repro_torch.kernels.qmm import kernel as qmm_kernel
    from repro_torch.kernels.qmm.ops import qmm_batched
    from repro_torch.kernels.qmm.ref import qmm_batched_ref
    from repro_torch.models.quantized import quantize_weight

    gen = torch.Generator().manual_seed(11)
    qw = quantize_weight(torch.randn(4, 40, 24, generator=gen), 4)
    x = torch.randn(4, 6, 40, generator=gen)
    rows = torch.tensor([6, 0, 3, 9], dtype=torch.int32)
    full = qmm_batched_ref(x, qw.packed, qw.scale, 4, 40)
    got = qmm_batched_ref(x, qw.packed, qw.scale, 4, 40, rows)
    in_use = torch.arange(6) < rows[:, None]
    assert torch.equal(got[in_use], full[in_use]) and bool((got[~in_use] == 0).all())
    assert bool((full[~in_use] != 0).any())
    xz = x * in_use[..., None]
    assert torch.equal(qmm_batched_ref(xz, qw.packed, qw.scale, 4, 40, rows),
                       qmm_batched_ref(xz, qw.packed, qw.scale, 4, 40))
    launched = (qmm_kernel.QMM_EXPERTS.launches, qmm_kernel.QMM_BATCHED.launches)
    assert torch.equal(qmm_batched(x, qw.packed, qw.scale, 4, 40, rows), got)
    assert torch.equal(qmm_batched(x.to(torch.bfloat16), qw.packed, qw.scale, 4, 40, rows),
                       qmm_batched_ref(x.to(torch.bfloat16), qw.packed, qw.scale, 4, 40, rows))
    assert (qmm_kernel.QMM_EXPERTS.launches, qmm_kernel.QMM_BATCHED.launches) == launched


def test_expert_kernel_refuses_cpu_tensors():
    """QMM_EXPERTS launches only on CUDA tensors: a CPU x or rows raises
    before any build."""
    from repro_torch.kernels.qmm import kernel as qmm_kernel
    from repro_torch.models.quantized import quantize_weight

    qw = quantize_weight(torch.randn(2, 64, 16), 4)
    x = torch.zeros(2, 3, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        qmm_kernel.QMM_EXPERTS(x, qw.packed, qw.scale, 4, 64,
                               torch.tensor([3, 1], dtype=torch.int32))
    assert qmm_kernel.experts_shape_ok(qw.packed, 64)
    assert not qmm_kernel.experts_shape_ok(quantize_weight(torch.randn(2, 36, 16), 4).packed, 36)
