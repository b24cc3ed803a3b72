"""The port's MoE FFN (``repro_torch.models.transformer.moe``) against the
JAX package's ``repro.models.transformer.moe``, on the CPU.

Inputs are drawn with numpy from fixed seeds and fed to both packages in
float32: the port's segment sum accumulates in f32 and rounds once, JAX's
scatter-add in the input dtype, so bf16 would compare the two roundings
(``test_torch_gnn.py::test_bf16_segment_sum_accumulates_in_f32``). Exact
unless stated: ``capacity``, the expert ids, ``pos`` and ``keep`` and the
dispatch buffer; the gates and ``aux`` within 1e-6 (the two libraries'
float32 products and softmax are not bit-equal); ``moe_ffn``'s output
within rtol = atol = 1e-5. On the CPU the dispatch and combine take the
``gather_rows`` and ``segment_reduce`` wrappers' plain versions.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models.transformer import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models.transformer import moe as tmoe  # noqa: E402

MOE_ARCHS = ("deepseek-moe-16b", "qwen3-moe-235b-a22b")
FFN_TOL = dict(rtol=1e-5, atol=1e-5)
ROUTE_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _mcfgs(arch, **changes):
    """(JAX, port) MoE configs of ``arch``'s reduced model, with ``changes``."""
    j = dataclasses.replace(jconfigs.get_spec(arch).reduced.moe, **changes)
    t = dataclasses.replace(tconfigs.get_spec(arch).reduced.moe, **changes)
    return j, t


def _params(mcfg, d, seed):
    """numpy parameters in the JAX module's tree, from ``seed``."""
    rng = np.random.default_rng(seed)
    e, f = mcfg.n_experts, mcfg.d_ff_expert

    def normal(*shape, scale):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    p = {
        "router": normal(d, e, scale=d**-0.5),
        "w1": normal(e, d, f, scale=d**-0.5),
        "w3": normal(e, d, f, scale=d**-0.5),
        "w2": normal(e, f, d, scale=f**-0.5),
    }
    if mcfg.n_shared_experts:
        sf = mcfg.shared_ff
        p["shared"] = {"w1": normal(d, sf, scale=d**-0.5),
                       "w3": normal(d, sf, scale=d**-0.5),
                       "w2": normal(sf, d, scale=sf**-0.5)}
    return p


def _both(tree):
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(_t, tree))


def _margin(probs: np.ndarray, k: int) -> float:
    """The smallest gap between neighbouring probabilities among each
    token's k + 1 largest: how near a tie the routing came."""
    top = -np.sort(-probs, axis=-1)[:, : k + 1]
    return float(np.diff(-top, axis=-1).min())


# -- capacity ------------------------------------------------------------------


@pytest.mark.parametrize("which", ["config", "reduced"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches(arch, which):
    """``capacity`` equals JAX's for every T in 1…10⁵, the round-up to a
    multiple of 8 and the floor of 8 included."""
    jm = getattr(jconfigs.get_spec(arch), which).moe
    tm = getattr(tconfigs.get_spec(arch), which).moe
    got = [tmoe.capacity(n, tm) for n in range(1, 100_001)]
    want = [jmoe.capacity(n, jm) for n in range(1, 100_001)]
    assert got == want
    assert min(got) == 8 and all(c % 8 == 0 for c in got)


# -- routing -------------------------------------------------------------------


ROUTE_CASES = [(arch, {}) for arch in MOE_ARCHS] + [("deepseek-moe-16b", {"top_k": 1})]


@pytest.mark.parametrize("arch,changes", ROUTE_CASES)
def test_route_matches(arch, changes):
    """Expert ids exact (sorted by probability, as ``lax.top_k``), gates and
    ``aux`` within 1e-6, over 500 tokens. A zero token (every probability
    equal) takes experts 0…k−1 in both."""
    jm, tm = _mcfgs(arch, **changes)
    d = jconfigs.get_spec(arch).reduced.d_model
    rng = np.random.default_rng(11)
    x = rng.normal(size=(500, d)).astype(np.float32)
    x[17] = 0.0
    w = (rng.normal(size=(d, jm.n_experts)) * d**-0.5).astype(np.float32)
    jidx, jgate, jaux = jmoe.route(jnp.asarray(x), jnp.asarray(w), jm)
    tidx, tgate, taux = tmoe.route(_t(x), _t(w), tm)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), axis=-1))
    margin = _margin(np.delete(probs, 17, axis=0), jm.top_k)
    assert tidx.dtype == torch.int32 and tuple(tidx.shape) == (500, jm.top_k)
    np.testing.assert_array_equal(
        tidx.numpy(), np.asarray(jidx),
        err_msg=f"smallest probability gap among the top {jm.top_k + 1}: {margin}",
    )
    np.testing.assert_array_equal(tidx[17].numpy(), np.arange(jm.top_k))
    np.testing.assert_allclose(tgate.numpy(), np.asarray(jgate), **ROUTE_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **ROUTE_TOL)


# -- dispatch --------------------------------------------------------------------


def _dispatch_cases():
    rng = np.random.default_rng(5)
    t, k, e = 96, 2, 8
    rand = rng.integers(0, e, (t, k)).astype(np.int32)
    one = np.zeros((t, k), np.int32)  # every slot to expert 0 ...
    one[:, 1] = 3  # ... or expert 3
    skew = np.where(rng.random((t, k)) < 0.7, 5, rng.integers(0, e, (t, k))).astype(np.int32)
    return [
        ("uniform", rand, 1.25),
        ("one_expert", one, 1.25),
        ("skewed", skew, 1.25),
        ("factor_0.25", rand, 0.25),
    ]


@pytest.mark.parametrize("name,idx,factor", _dispatch_cases(), ids=lambda v: str(v)[:12])
def test_dispatch_indices_match(name, idx, factor):
    """``pos`` and ``keep`` exact, with overflow: every token to one expert,
    a skewed mix, and capacity_factor 0.25. The kept slots of each expert
    are its first ``cap`` in (token, slot) order."""
    jm, tm = _mcfgs("deepseek-moe-16b", n_experts=8, top_k=2, capacity_factor=factor)
    cap = tmoe.capacity(idx.shape[0], tm)
    jpos, jkeep = jmoe.dispatch_indices(jnp.asarray(idx), 8, cap)
    tpos, tkeep = tmoe.dispatch_indices(_t(idx), 8, cap)
    assert tpos.dtype == torch.int32 and tkeep.dtype == torch.bool
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    flat = idx.reshape(-1)
    for e in range(8):
        mine = np.flatnonzero(flat == e)
        np.testing.assert_array_equal(tpos.numpy()[mine], np.arange(mine.size))
        np.testing.assert_array_equal(tkeep.numpy()[mine], np.arange(mine.size) < cap)
    if name != "uniform":
        assert not tkeep.all()


@pytest.mark.parametrize("name,idx,factor", _dispatch_cases(), ids=lambda v: str(v)[:12])
def test_dispatch_buffer_matches_scatter_add(name, idx, factor):
    """The inverse-map gather (``dispatch``) equals JAX's zero buffer plus
    the scatter-add of ``x[token_id]`` over the kept slots, exactly."""
    jm, tm = _mcfgs("deepseek-moe-16b", n_experts=8, top_k=2, capacity_factor=factor)
    t, k = idx.shape
    cap = tmoe.capacity(t, tm)
    x = np.random.default_rng(6).normal(size=(t, 16)).astype(np.float32)
    pos, keep = jmoe.dispatch_indices(jnp.asarray(idx), 8, cap)
    slot = jnp.where(keep, jnp.asarray(idx).reshape(-1) * cap + pos, 8 * cap)
    token_id = jnp.repeat(jnp.arange(t), k)
    want = jnp.zeros((8 * cap, 16)).at[slot].add(jnp.asarray(x)[token_id], mode="drop")
    got = tmoe.dispatch(_t(x), _t(slot).to(torch.int32),
                        _t(token_id).to(torch.int32), 8 * cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the FFN -----------------------------------------------------------------------


FFN_CASES = [
    ("deepseek-moe-16b", {}),  # shared experts
    ("qwen3-moe-235b-a22b", {}),  # none
    ("deepseek-moe-16b", {"capacity_factor": 0.25}),  # drops, shared
    ("qwen3-moe-235b-a22b", {"capacity_factor": 0.25}),  # drops, none
    ("deepseek-moe-16b", {"capacity_factor": 4.0}),  # no drop
]


def _ffn_inputs(arch, changes, t=120, seed=3):
    jm, tm = _mcfgs(arch, **changes)
    d = jconfigs.get_spec(arch).reduced.d_model
    x = np.random.default_rng(seed).normal(size=(t, d)).astype(np.float32)
    return jm, tm, x, _params(jm, d, seed + 1)


@pytest.mark.parametrize("arch,changes", FFN_CASES)
def test_moe_ffn_matches(arch, changes):
    """``moe_ffn``'s y within 1e-5 of JAX's ``_moe_ffn_local``, ``aux``
    within 1e-6; with and without shared experts and drops."""
    jm, tm, x, tree = _ffn_inputs(arch, changes)
    jp, tp = _both(tree)
    jy, jaux = jmoe._moe_ffn_local(jnp.asarray(x), jp, jm)
    slots, dropped = tmoe.moe_ffn.slots, tmoe.moe_ffn.dropped
    ty, taux = tmoe.moe_ffn(_t(x), tp, tm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FFN_TOL)
    np.testing.assert_allclose(taux.item(), float(jaux), **ROUTE_TOL)
    idx, _, _ = jmoe.route(jnp.asarray(x), jp["router"], jm)
    _, keep = jmoe.dispatch_indices(idx, jm.n_experts, jmoe.capacity(x.shape[0], jm))
    assert tmoe.moe_ffn.slots - slots == keep.size
    assert int(tmoe.moe_ffn.dropped - dropped) == int((~np.asarray(keep)).sum())
    assert (int(tmoe.moe_ffn.dropped - dropped) > 0) == (changes.get("capacity_factor") == 0.25)


def _silu(v):
    return v / (1.0 + np.exp(-v))


@pytest.mark.parametrize("arch,changes", FFN_CASES)
def test_moe_ffn_against_float64_oracle(arch, changes):
    """Each token's y against a dense float64 sum over its kept (token,
    expert) pairs, gate-weighted, plus the shared experts; the pairs and
    gates from the port's ``route`` and ``dispatch_indices``."""
    _, tm, x, tree = _ffn_inputs(arch, changes, seed=9)
    tp = jax.tree_util.tree_map(_t, tree)
    y, _ = tmoe.moe_ffn(_t(x), tp, tm)
    idx, gate, _ = tmoe.route(_t(x), tp["router"], tm)
    _, keep = tmoe.dispatch_indices(idx, tm.n_experts, tmoe.capacity(x.shape[0], tm))
    keep = keep.numpy().reshape(idx.shape)
    idx, gate = idx.numpy(), gate.numpy().astype(np.float64)
    w = {k: np.asarray(v, np.float64) for k, v in tree.items() if k != "shared"}
    want = np.zeros(x.shape)
    for t_ in range(x.shape[0]):
        xt = x[t_].astype(np.float64)
        for j in range(tm.top_k):
            if keep[t_, j]:
                e = idx[t_, j]
                h = _silu(xt @ w["w1"][e]) * (xt @ w["w3"][e])
                want[t_] += gate[t_, j] * (h @ w["w2"][e])
    if "shared" in tree:
        sh = {k: np.asarray(v, np.float64) for k, v in tree["shared"].items()}
        xs = x.astype(np.float64)
        want += (_silu(xs @ sh["w1"]) * (xs @ sh["w3"])) @ sh["w2"]
    np.testing.assert_allclose(y.numpy(), want, **FFN_TOL)


def test_dropped_slot_reads_the_last_row():
    """A dropped slot reads the last expert row and is weighted 0, as in
    JAX: NaN there reaches exactly the tokens JAX's output has NaN in."""
    jm, tm, x, tree = _ffn_inputs("qwen3-moe-235b-a22b", {"capacity_factor": 0.25})
    tree["w2"][-1, :, 0] = np.nan  # the last expert's output column 0
    jp, tp = _both(tree)
    jy = np.asarray(jmoe._moe_ffn_local(jnp.asarray(x), jp, jm)[0])
    ty = tmoe.moe_ffn(_t(x), tp, tm)[0].numpy()
    assert np.isnan(jy).any() and not np.isnan(jy).all()
    np.testing.assert_array_equal(np.isnan(ty), np.isnan(jy))
    ok = ~np.isnan(jy)
    np.testing.assert_allclose(ty[ok], jy[ok], **FFN_TOL)


# -- parameters ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_params_layout(arch, dtype):
    """Names, shapes and dtypes of ``init_moe_params`` equal JAX's, and the
    draws have the JAX module's scales (std 1/√D for the router, w1 and
    w3, 1/√F for w2)."""
    jm = jconfigs.get_spec(arch).reduced.moe
    tm = tconfigs.get_spec(arch).reduced.moe
    d = 64
    jtree = jmoe.init_moe_params(jax.random.PRNGKey(0), d, jm, getattr(jnp, dtype))
    gen = torch.Generator().manual_seed(0)
    ttree = tmoe.init_moe_params(gen, d, tm, getattr(torch, dtype))
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = jax.tree_util.tree_flatten_with_path(ttree)[0]
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    for (path, j), (_, t) in zip(jflat, tflat):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == j.dtype.name, path
    f = tm.d_ff_expert
    for name, want in (("router", d**-0.5), ("w1", d**-0.5), ("w3", d**-0.5), ("w2", f**-0.5)):
        assert abs(ttree[name].float().std().item() / want - 1) < 0.05, name


# -- the card smoke's MoE phase, rehearsed on the CPU -----------------------------------


def _chip_smoke():
    """``chip_smoke.py`` at the root of the repo, imported as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pinned_routes_reproduce_the_prefill():
    """The smoke's check (c) pins a prefill's routing to a logged one: pinned
    to its own log, a prefill gives the same logits bit for bit and counts
    no flip; pinned to another token's experts, it differs."""
    from repro_torch.models.transformer import model as ttm

    smoke = _chip_smoke()
    cfg = tconfigs.get_spec("deepseek-moe-16b").reduced
    params = ttm.init(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (2, 24)).astype(np.int32))
    log = []
    with smoke.moe_routes(log):
        want = ttm.prefill(params, tokens, cfg)[0]
    assert len(log) == cfg.n_layers and tuple(log[0].shape) == (48, cfg.moe.top_k)
    flips = []
    with smoke.moe_routes(flips, log):
        got = ttm.prefill(params, tokens, cfg)[0]
    assert torch.equal(got, want)
    assert len(flips) == cfg.n_layers and not any(bool(f.any()) for f, _ in flips)
    assert all(bool((gap >= 0).all()) for _, gap in flips)
    other = [ids.roll(1, dims=0) for ids in log]
    flips = []
    with smoke.moe_routes(flips, other):
        moved = ttm.prefill(params, tokens, cfg)[0]
    assert not torch.allclose(moved, want) and any(bool(f.any()) for f, _ in flips)


def test_smoke_moe_phase_on_cpu(capsys):
    """``chip_smoke.moe_path`` end to end on the CPU (the reduced
    deepseek-moe config in bf16; the wrappers take their plain versions):
    serve twice, checks (a)-(c), the launch counters read; no kernel rows
    without the card."""
    smoke = _chip_smoke()
    cfg = dataclasses.replace(tconfigs.get_spec("deepseek-moe-16b").reduced,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    rows = smoke.moe_path(cfg, 2, 160, 6, 0, torch.device("cpu"), "cpu")
    assert rows == []
    out = capsys.readouterr().out
    for line in ("moe_serve", "moe_checks", "moe_teacher_forced", "moe_phase"):
        assert f"\n{line} " in f"\n{out}", line
    serve = json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("moe_serve "))[len("moe_serve "):])
    assert serve["prefill_slots"] == 2 * 160 * cfg.moe.top_k * cfg.n_layers
    assert serve["prefill_dropped"] > 0  # at capacity factor 1.25 some experts overflow
    assert serve["prefill_dropped_share"] == serve["prefill_dropped"] / serve["prefill_slots"]
