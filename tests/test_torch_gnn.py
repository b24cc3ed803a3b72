"""The port's GNN forward path against the JAX package, on the CPU.

The four GNN variants at the JAX suite's small configs
(``tests/test_models_gnn_recsys.py``: 2 layers, d_hidden 16, d_in 8, 5
outputs), the JAX package's own initialised parameters carried across as
numpy arrays, on ``gnn_full_batch(64, 4.0, 8, 5, seed=1)`` and on a padded
graph with isolated vertices; the ``mp_*`` ops, the sampler's selection and
the sampled GraphSAGE forward. On the CPU the ``gather_rows`` and
``segment_reduce`` wrappers take their plain versions.

Tolerances: batches, configs, the sampler's blocks and the ``mp_*`` ops on
min/max are exact; float32 outputs at rtol = atol = 2e-5 × max|out|
(``tests/test_kernels.py``'s ``TOL``, scaled to the output); bfloat16 PNA
at rtol = atol = 3e-2 × max|out|, on a graph whose in-degrees stay at or
below 16 (the port sums bf16 in f32, JAX in bf16: exact up to 256 ones,
and the difference past that is pinned by
``test_bf16_segment_sum_accumulates_in_f32``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.common import GNN_SHAPES  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.graph import generators as jgen  # noqa: E402
from repro.graph import ops as jops  # noqa: E402
from repro.graph import sampler as jsampler  # noqa: E402
from repro.graph import structure as jstruct  # noqa: E402
from repro.models.gnn import GNNConfig as JConfig  # noqa: E402
from repro.models.gnn import layers as jL  # noqa: E402
from repro.models.gnn import models as jm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.graph import generators as tgen  # noqa: E402
from repro_torch.graph import ops as tops  # noqa: E402
from repro_torch.graph import sampler as tsampler  # noqa: E402
from repro_torch.graph import structure as tstruct  # noqa: E402
from repro_torch.models.gnn import GNNConfig as TConfig  # noqa: E402
from repro_torch.models.gnn import layers as tL  # noqa: E402
from repro_torch.models.gnn import models as tm  # noqa: E402

F32 = 2e-5
BF16 = 3e-2

#: tests/test_models_gnn_recsys.py's VARIANTS, with sage over every aggregator
VARIANTS = [
    ("sage", dict(aggregator="mean")),
    ("sage", dict(aggregator="sum")),
    ("sage", dict(aggregator="max")),
    ("sage", dict(aggregator="min")),
    ("gat", dict(n_heads=4)),
    ("pna", dict()),
    ("graphcast", dict(task="regression", d_edge=16)),
]
IDS = ["sage-mean", "sage-sum", "sage-max", "sage-min", "gat", "pna", "graphcast"]
GNN_IDS = ("graphsage-reddit", "gat-cora", "pna", "graphcast")


def _cfg(variant, kw, **more):
    return JConfig(name=variant, variant=variant, n_layers=2, d_hidden=16, d_in=8,
                   n_out=5, **kw, **more)


def _port_cfg(cfg):
    return TConfig(**dataclasses.asdict(cfg))


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.float()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = tol * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=scale)


def _params(cfg, seed=0):
    jp = jm.init(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, tm.params_from_arrays(_port_cfg(cfg), tree, device="cpu")


def _batches(task="node_class", **kw):
    jb = jpipe.gnn_full_batch(64, 4.0, 8, 5, seed=1, task=task, n_out=5)
    tb = tpipe.gnn_full_batch(64, 4.0, 8, 5, seed=1, task=task, n_out=5, device="cpu", **kw)
    return jb, tb


def _padded_batches(seed=5):
    """A graph of 40 vertices whose last 10 are isolated, vertex 0 with
    in-edges only, and 7 padding edges; the same edges through both
    packages' ``from_edge_list``."""
    rng = np.random.default_rng(seed)
    n = 40
    src = rng.integers(0, 30, 90).astype(np.int32)
    dst = rng.integers(0, 30, 90).astype(np.int32)
    src = np.where(src == 0, 1, src)  # vertex 0 sends nothing
    keep = src != dst
    src, dst = src[keep], dst[keep]
    e = src.shape[0] + 7
    jg = jstruct.from_edge_list(src, dst, n, pad_to=e)
    tg = tstruct.from_edge_list(src, dst, n, pad_to=e, device="cpu")
    x = rng.normal(size=(n, 8)).astype(np.float32)
    jb = {"x": jnp.asarray(x), "src": jg.src, "dst": jg.dst, "emask": jg.edge_mask}
    tb = {"x": _t(x), "src": tg.src, "dst": tg.dst, "emask": tg.edge_mask}
    return jb, tb


# -- data and configs ------------------------------------------------------------


@pytest.mark.parametrize("task", ["node_class", "regression"])
def test_full_batch_equals_jax(task):
    """``gnn_full_batch`` gives the JAX batch bit for bit, dtypes included."""
    jb, tb = _batches(task)
    assert set(tb) == set(jb)
    for k in jb:
        want = np.asarray(jb[k])
        got = tb[k].numpy()
        assert got.dtype == want.dtype, k
        assert np.array_equal(got, want), k
    assert bool((tb["dst"][1:] >= tb["dst"][:-1]).all())


@pytest.mark.parametrize("shape_id", sorted(GNN_SHAPES))
@pytest.mark.parametrize("arch", GNN_IDS)
def test_resolve_gnn_config_matches(arch, shape_id):
    j = jconfigs.resolve_gnn_config(jconfigs.get_spec(arch).config, shape_id,
                                    GNN_SHAPES[shape_id])
    t = tconfigs.resolve_gnn_config(tconfigs.get_spec(arch).config, shape_id,
                                    GNN_SHAPES[shape_id])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize(
    "variant,kw", VARIANTS[3:] + [("pna", dict(n_layers=1))],
    ids=["sage", "gat", "pna", "graphcast", "pna-one-layer"],
)
def test_init_layout_matches(variant, kw):
    """The port's own ``init`` gives the JAX tree's structure, shapes and
    dtypes (PNA's one-layer tail is ``None`` in both)."""
    kw = dict(kw)
    n_layers = kw.pop("n_layers", 2)
    cfg = dataclasses.replace(_cfg(variant, kw), n_layers=n_layers)
    jleaves, jdef = jax.tree_util.tree_flatten(jm.init(jax.random.PRNGKey(0), cfg))
    own = tm.init(_port_cfg(cfg), seed=0, device="cpu")
    tleaves, tdef = jax.tree_util.tree_flatten(own)
    assert tdef == jdef
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"


def test_entry_points_default_to_the_card():
    """Without ``device=`` the batch and the parameters ask for the card, and
    without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = _port_cfg(_cfg("sage", {}))
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.gnn_full_batch(64, 4.0, 8, 5, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        tm.init(cfg)
    assert tm.init(cfg, device="cpu")["head"].device.type == "cpu"


# -- ops ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6,), (6, 4)], ids=["width6", "heads6x4"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
def test_mp_segment_reduce_matches(op, shape):
    """``mp_segment_reduce`` (masked, sentinel ids, empty segments) equals
    the JAX function off the mesh; min/max exactly."""
    rng = np.random.default_rng(11)
    n, e = 12, 70
    ids = np.sort(rng.integers(0, n + 1, e)).astype(np.int32)  # n: sentinel
    ids[(ids > 3) & (ids < 6)] = 7  # empty segments
    ids = np.sort(ids)
    vals = rng.normal(size=(e,) + shape).astype(np.float32)
    mask = rng.random(e) < 0.7
    want = jops.mp_segment_reduce(jnp.asarray(vals), jnp.asarray(ids), n, op,
                                  mask=jnp.asarray(mask))
    got = tops.mp_segment_reduce(_t(vals), _t(ids), n, op, mask=_t(mask),
                                 offsets=tstruct.segment_offsets(_t(ids), n))
    if op == "sum":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32, atol=F32)
    else:
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_mp_gather_and_edge_softmax_match():
    """``mp_gather`` of rows (sentinel index clipped) and ``mp_edge_softmax``
    over heads equal the JAX functions off the mesh."""
    rng = np.random.default_rng(12)
    n, e = 10, 50
    table = rng.normal(size=(n, 3, 2)).astype(np.float32)
    idx = rng.integers(0, n + 1, e).astype(np.int32)
    assert np.array_equal(tops.mp_gather(_t(table), _t(idx)).numpy(),
                          np.asarray(jops.mp_gather(jnp.asarray(table), jnp.asarray(idx))))
    ids = np.sort(rng.integers(0, n + 1, e)).astype(np.int32)
    scores = rng.normal(size=(e, 4)).astype(np.float32) * 3
    mask = rng.random(e) < 0.8
    want = jops.mp_edge_softmax(jnp.asarray(scores), jnp.asarray(ids), n,
                                mask=jnp.asarray(mask))
    got = tops.mp_edge_softmax(_t(scores), _t(ids), n, mask=_t(mask),
                               offsets=tstruct.segment_offsets(_t(ids), n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32, atol=F32)


def test_bf16_segment_sum_accumulates_in_f32():
    """The one difference kept on purpose: JAX's ``segment_sum`` of bf16
    accumulates in bf16 (1000 ones sum to 256, where 256 + 1 rounds back to
    256), the port's in f32 (1000), kernel and plain version alike."""
    ones = np.ones(1000, np.float32)
    ids = np.zeros(1000, np.int32)
    want = jops.segment_reduce(jnp.asarray(ones, jnp.bfloat16), jnp.asarray(ids), 1, "sum")
    got = tops.segment_reduce(_t(ones).to(torch.bfloat16), _t(ids), 1, "sum",
                              offsets=tstruct.segment_offsets(_t(ids), 1))
    assert float(want[0]) == 256.0
    assert float(got[0]) == 1000.0 and got.dtype == torch.bfloat16


# -- layers and forward --------------------------------------------------------------


def _layer_pairs(cfg, jp, tp, jb, tb):
    """(JAX, port) closures of each layer of ``cfg`` in turn, each fed the
    JAX output of the one before (as numpy)."""
    src, dst, m, n = jb["src"], jb["dst"], jb["emask"], jb["x"].shape[0]
    tsrc, tdst, tmask = tb["src"], tb["dst"], tb["emask"]
    off = tm.dst_offsets(tdst, n)
    if cfg.variant in ("sage", "gat"):
        for jl, tl in zip(jp["layers"], tp["layers"]):
            if cfg.variant == "sage":
                yield (lambda h, jl=jl: jL.sage_layer(jl, h, src, dst, m, n, cfg.aggregator),
                       lambda h, tl=tl: tL.sage_layer(tl, h, tsrc, tdst, tmask, n,
                                                      cfg.aggregator, offsets=off))
            else:
                yield (lambda h, jl=jl: jL.gat_layer(jl, h, src, dst, m, n, cfg.n_heads,
                                                     cfg.d_hidden),
                       lambda h, tl=tl: tL.gat_layer(tl, h, tsrc, tdst, tmask, n, cfg.n_heads,
                                                     cfg.d_hidden, offsets=off))
    elif cfg.variant == "pna":
        args = (cfg.pna_aggregators, cfg.pna_scalers, cfg.pna_delta)
        stacked_j = [jax.tree_util.tree_map(lambda a, i=i: a[i], jp["layers"])
                     for i in range(cfg.n_layers - 1)]
        stacked_t = [tm._layer(tp["layers"], i) for i in range(cfg.n_layers - 1)]
        for jl, tl in zip([jp["layer0"]] + stacked_j, [tp["layer0"]] + stacked_t):
            yield (lambda h, jl=jl: jL.pna_layer(jl, h, src, dst, m, n, *args),
                   lambda h, tl=tl: tL.pna_layer(tl, h, tsrc, tdst, tmask, n, *args,
                                                 offsets=off))
    else:  # graphcast: the processor blocks on (h, e)
        for i in range(cfg.n_layers):
            jl = jax.tree_util.tree_map(lambda a, i=i: a[i], jp["layers"])
            tl = tm._layer(tp["layers"], i)
            yield (lambda he, jl=jl: jL.mpnn_layer(jl, he[0], he[1], src, dst, m, n),
                   lambda he, tl=tl: tL.mpnn_layer(tl, he[0], he[1], tsrc, tdst, tmask, n,
                                                   offsets=off))


@pytest.mark.parametrize("variant,kw", VARIANTS, ids=IDS)
def test_layers_match(variant, kw):
    """Each layer of each variant equals the JAX layer on the same input."""
    cfg = _cfg(variant, kw)
    jp, tp = _params(cfg)
    jb, tb = _batches(cfg.task)
    if variant == "graphcast":
        rng = np.random.default_rng(2)
        e = jb["src"].shape[0]
        h = (rng.normal(size=(64, 16)).astype(np.float32),
             rng.normal(size=(e, 16)).astype(np.float32))
    else:
        h = np.asarray(jb["x"])
    for jfn, tfn in _layer_pairs(cfg, jp, tp, jb, tb):
        if variant == "graphcast":
            want = jfn((jnp.asarray(h[0]), jnp.asarray(h[1])))
            got = tfn((_t(h[0]), _t(h[1])))
            for g, w in zip(got, want):
                _close(g, w, F32)
            h = tuple(np.asarray(w) for w in want)
        else:
            want = jfn(jnp.asarray(h))
            _close(tfn(_t(h)), want, F32)
            h = np.asarray(want)


@pytest.mark.parametrize("variant,kw", VARIANTS, ids=IDS)
def test_forward_matches(variant, kw):
    """``forward`` of each variant equals JAX's on ``gnn_full_batch``."""
    cfg = _cfg(variant, kw)
    jp, tp = _params(cfg)
    jb, tb = _batches(cfg.task)
    want = jm.forward(jp, jb, cfg)
    got = tm.forward(tp, tb, _port_cfg(cfg))
    assert got.dtype == torch.float32
    _close(got, want, F32)


@pytest.mark.parametrize("variant,kw", VARIANTS, ids=IDS)
def test_forward_with_isolated_vertices_and_padding(variant, kw):
    """Isolated vertices (empty segments: mean 0, max/min mapped to 0) and
    padding edges (``src = dst = n``, masked) give JAX's outputs."""
    cfg = _cfg(variant, kw)
    jp, tp = _params(cfg, seed=4)
    jb, tb = _padded_batches()
    assert int(tb["dst"][-1]) == 40 and not bool(tb["emask"][-7:].any())
    for k in ("src", "dst", "emask"):
        assert np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
    _close(tm.forward(tp, tb, _port_cfg(cfg)), jm.forward(jp, jb, cfg), F32)


@pytest.mark.parametrize("variant,kw", [VARIANTS[0], VARIANTS[4], VARIANTS[5]],
                         ids=["sage", "gat", "pna"])
def test_forward_on_unsorted_edges_on_the_cpu(variant, kw):
    """On the CPU the plain versions read the ids, so edges in any order give
    JAX's outputs (on the card ``dst`` must be ascending)."""
    cfg = _cfg(variant, kw)
    jp, tp = _params(cfg)
    jb, tb = _batches()
    perm = np.random.default_rng(3).permutation(jb["src"].shape[0])
    for k in ("src", "dst", "emask"):
        jb[k] = jnp.asarray(np.asarray(jb[k])[perm])
        tb[k] = tb[k][torch.from_numpy(perm)]
    assert tm.dst_offsets(tb["dst"], 64) is None
    _close(tm.forward(tp, tb, _port_cfg(cfg)), jm.forward(jp, jb, cfg), F32)


def test_pna_bf16_matches():
    """PNA computing in bf16 (the full config's dtype) on a graph whose
    in-degrees stay at or below 16, at bf16's tolerance."""
    cfg = _cfg("pna", {}, compute_dtype="bfloat16")
    jp, tp = _params(cfg)
    jg = jgen.erdos_renyi(96, 5.0, seed=3)
    tg = tgen.erdos_renyi(96, 5.0, seed=3, device="cpu")
    assert int(tops.in_degrees(tg).max()) <= 16
    x = np.random.default_rng(4).normal(size=(96, 8)).astype(np.float32)
    jb = {"x": jnp.asarray(x), "src": jg.src, "dst": jg.dst, "emask": jg.edge_mask}
    tb = {"x": _t(x), "src": tg.src, "dst": tg.dst, "emask": tg.edge_mask}
    _close(tm.forward(tp, tb, _port_cfg(cfg)), jm.forward(jp, jb, cfg), BF16)


# -- the sampler and the minibatch path ------------------------------------------------


def _sampler_graphs():
    """A directed graph of 50 vertices: edges among the first 40 and into
    vertex 45 only, so 40-44 and 46-49 have no in-neighbor."""
    rng = np.random.default_rng(8)
    src = rng.integers(0, 40, 200).astype(np.int32)
    dst = np.concatenate([rng.integers(0, 40, 195), np.full(5, 45)]).astype(np.int32)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    return (jstruct.from_edge_list(src, dst, 50, pad_to=src.shape[0] + 3),
            tstruct.from_edge_list(src, dst, 50, pad_to=src.shape[0] + 3, device="cpu"))


def test_csr_from_graph_matches():
    jg, tg = _sampler_graphs()
    jc, tc = jsampler.CSR.from_graph(jg), tsampler.CSR.from_graph(tg)
    assert tc.n_vertices == jc.n_vertices
    assert np.array_equal(tc.indptr.numpy(), np.asarray(jc.indptr))
    assert np.array_equal(tc.indices.numpy(), np.asarray(jc.indices))
    assert tc.indptr.dtype == tc.indices.dtype == torch.int32


def test_sampler_selection_matches_jax_draws():
    """Fed JAX's own ``randint`` draws, the port's selection gives JAX's
    ``sample_khop`` blocks exactly: degree-0 seeds sample the sentinel with
    mask False, and the sentinel frontier of the next hop stays dead."""
    jg, tg = _sampler_graphs()
    jc, tc = jsampler.CSR.from_graph(jg), tsampler.CSR.from_graph(tg)
    seeds = np.array([0, 3, 41, 45, 45, 49, 17, 39, 44, 2], np.int32)
    key = jax.random.PRNGKey(21)
    fanouts = (4, 3)
    want = jsampler.sample_khop(jc, jnp.asarray(seeds), fanouts, key)
    indptr = np.asarray(jc.indptr)
    frontier = seeds
    for f, wblk in zip(fanouts, want):
        key, sub = jax.random.split(key)
        safe = np.minimum(frontier, 49)
        degree = indptr[safe + 1] - indptr[safe]
        r = jax.random.randint(sub, (frontier.shape[0], f), 0,
                               jnp.maximum(jnp.asarray(degree), 1)[:, None])
        got = tsampler._select(tc, _t(frontier), _t(r).to(torch.int32))
        assert np.array_equal(got.nodes.numpy(), np.asarray(wblk.nodes))
        assert np.array_equal(got.neighbors.numpy(), np.asarray(wblk.neighbors))
        assert np.array_equal(got.mask.numpy(), np.asarray(wblk.mask))
        assert got.neighbors.dtype == torch.int32
        frontier = np.asarray(wblk.neighbors).reshape(-1)
    assert (frontier == 50).any() and (np.asarray(want[1].nodes) == 50).any()


@pytest.mark.parametrize("seed", range(-1, -52, -1))
def test_sampler_negative_seed_matches_jax(seed):
    """A negative seed reads ``indptr`` as JAX's ``x[ids]`` does (ids in
    ``[-(N+1), -1]`` wrap over the N + 1 entries, then clamp): fed JAX's
    draws, the port's block equals JAX's ``sample_khop`` for every seed
    from −1 to −(N+1) (ROADMAP C-F5)."""
    jg, tg = _sampler_graphs()
    jc, tc = jsampler.CSR.from_graph(jg), tsampler.CSR.from_graph(tg)
    seeds = jnp.asarray([seed], jnp.int32)
    key = jax.random.PRNGKey(3)
    (want,) = jsampler.sample_khop(jc, seeds, (4,), key)
    _, sub = jax.random.split(key)
    safe = jnp.minimum(seeds, 49)
    degree = jc.indptr[safe + 1] - jc.indptr[safe]
    r = jax.random.randint(sub, (1, 4), 0, jnp.maximum(degree, 1)[:, None])
    got = tsampler._select(tc, _t(np.asarray(seeds)), _t(r).to(torch.int32))
    assert np.array_equal(got.neighbors.numpy(), np.asarray(want.neighbors))
    assert np.array_equal(got.mask.numpy(), np.asarray(want.mask))


def test_sampler_draws_are_in_range_and_neighbors_are_in_neighbors():
    """The port's own draws: every masked neighbor is an in-neighbor of its
    node, every unmasked one the sentinel, and a node with in-neighbors has
    every slot masked in."""
    _, tg = _sampler_graphs()
    tc = tsampler.CSR.from_graph(tg)
    gen = torch.Generator().manual_seed(5)
    seeds = torch.arange(50, dtype=torch.int32)
    blocks = tsampler.sample_khop(tc, seeds, (6, 2), gen)
    indptr, indices = tc.indptr.numpy(), tc.indices.numpy()
    for blk in blocks:
        for v, nbrs, mask in zip(blk.nodes.numpy(), blk.neighbors.numpy(),
                                 blk.mask.numpy()):
            run = indices[indptr[min(v, 49)]:indptr[min(v, 49) + 1]] if v < 50 else []
            assert mask.all() == (len(run) > 0) and mask.all() == mask.any()
            assert all(u in run for u in nbrs[mask]) and (nbrs[~mask] == 50).all()


def test_sage_minibatch_forward_matches():
    """``sage_minibatch_forward`` equals JAX's on JAX's own sampled batch."""
    cfg = JConfig(name="sage", variant="sage", n_layers=2, d_hidden=16, d_in=8,
                  n_out=4, fanouts=(5, 3))
    jp, tp = _params(cfg)
    g = jgen.erdos_renyi(200, 6.0, seed=2)
    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.normal(size=(200, 8)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, 4, 200).astype(np.int32))
    batch = next(jpipe.gnn_minibatches(g, feats, labels, 16, (5, 3), seed=3))
    tb = {k: _t(v) for k, v in batch.items()}
    got = tm.sage_minibatch_forward(tp, tb, _port_cfg(cfg))
    assert tuple(got.shape) == (16, 4)
    _close(got, jm.sage_minibatch_forward(jp, batch, cfg), F32)


def test_gnn_minibatches_reads_the_sampled_rows():
    """The port's minibatches: seeds and blocks drawn from the generator
    (replayed here), features and labels read at them, the sentinel reading
    a zero row."""
    tg = tgen.erdos_renyi(120, 3.0, seed=6, device="cpu")
    rng = np.random.default_rng(1)
    feats = _t(rng.normal(size=(120, 5)).astype(np.float32))
    labels = _t(rng.integers(0, 4, 120).astype(np.int32))
    it = tpipe.gnn_minibatches(tg, feats, labels, 8, (4, 3), torch.Generator().manual_seed(9))
    batch = next(it)
    gen = torch.Generator().manual_seed(9)
    seeds = torch.randint(0, 120, (8,), generator=gen, dtype=torch.int32)
    b0, b1 = tsampler.sample_khop(tsampler.CSR.from_graph(tg), seeds, (4, 3), gen)
    ext = torch.cat([feats, torch.zeros(1, 5)])
    assert torch.equal(batch["seed_x"], ext[seeds.long()])
    assert torch.equal(batch["hop0_x"], ext[b0.neighbors.reshape(-1).long()])
    assert torch.equal(batch["hop1_x"], ext[b1.neighbors.reshape(-1).long()])
    assert torch.equal(batch["hop0_mask"], b0.mask) and torch.equal(batch["hop1_mask"], b1.mask)
    assert torch.equal(batch["labels"], labels[seeds.long()])
    assert tuple(batch["hop1_x"].shape) == (8 * 4 * 3, 5)
