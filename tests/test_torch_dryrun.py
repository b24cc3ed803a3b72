"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX package's,
on the CPU.

* ``abstract_params`` / ``count_params`` of all ten archs at full width
  (the GNNs at each shape's resolved config) equal JAX's: every leaf's
  path (the LM through ``params_tree``), shape and dtype; ``input_specs``
  and ``sampled_input_shapes`` likewise;
* ``roofline_terms`` equals JAX's on the same inputs and ``HW`` values,
  and the ring formulas give JAX's per-collective bytes on the same
  per-call bytes (JAX reads them from HLO text, written here);
* every cell's ``model_flops`` equals what JAX's ``lm_cell`` /
  ``gnn_cell`` / ``recsys_cell`` return, and ``palgol_partition_cell``
  JAX's record, both computed by one JAX subprocess on a 1 × 1 mesh
  (importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``);
* the kernels' fake routes: their launches per route equal the routes the
  wrappers' rules give the same step run for real (on the CPU's plain
  versions, each call counted by its rule), their outputs have the plain
  versions' shapes and dtypes, and no trace builds or loads a library;
* every cell at its reduced config gives ``ok`` or ``skipped``; two cells
  at full width give ``ok`` with the ``fits`` stated.

All exact: shapes, dtypes, counts and float formulas on the same inputs.
"""

import dataclasses
import functools
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jconfigs  # noqa: E402
from repro.graph import sampler as jsampler  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.gnn import models as jgm  # noqa: E402
from repro.models.recsys import autoint as jai  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.graph import sampler as tsampler  # noqa: E402
from repro_torch.kernels import build, fake  # noqa: E402
from repro_torch.kernels import autograd as kgrad  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as bag_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.gather_rows import ops as gather_ops  # noqa: E402
from repro_torch.kernels.scatter_rows import ops as scatter_ops  # noqa: E402
from repro_torch.kernels.segment_reduce import ops as segment_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.gnn import models as tgm  # noqa: E402
from repro_torch.models.recsys import autoint as tai  # noqa: E402
from repro_torch.models.transformer import model as ttm  # noqa: E402
from repro_torch.roofline import analysis as tanalysis  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
ARCHS = jconfigs.all_arch_ids()
CELLS = [(a, s) for a in ARCHS for s in jconfigs.get_spec(a).shapes]
GNN_CELLS = [(a, s) for a, s in CELLS if jconfigs.get_spec(a).family == "gnn"]


def _flat(tree, prefix=""):
    """``{path: (shape, dtype name)}`` of a nesting of dicts and lists whose
    leaves have ``shape`` and ``dtype`` (JAX's ShapeDtypeStructs or tensors)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


def _gnn_cfgs(arch, shape_id):
    jspec, tspec = jconfigs.get_spec(arch), tconfigs.get_spec(arch)
    shape = jspec.shapes[shape_id]
    return (jconfigs.resolve_gnn_config(jspec.config, shape_id, shape),
            tconfigs.resolve_gnn_config(tspec.config, shape_id, shape))


# ---------------------------------------------------------------------------
# abstract parameters and input specs


@functools.cache
def _jax_lm_abstract(arch):
    return jtm.abstract_params(jconfigs.get_spec(arch).config)


@pytest.mark.parametrize("arch", [a for a in ARCHS if jconfigs.get_spec(a).family != "gnn"])
def test_abstract_params_match_jax(arch):
    jspec, tspec = jconfigs.get_spec(arch), tconfigs.get_spec(arch)
    if jspec.family == "lm":
        want = _jax_lm_abstract(arch)
        got = ttm.abstract_params(tspec.config, device="cpu")
        assert all(isinstance(t, torch.Tensor) and fake.is_fake(t) for t in got.parameters())
        got_tree = ttm.params_tree(got)
    else:
        want = jai.abstract_params(jspec.config)
        got_tree = tai.abstract_params(tspec.config, device="cpu")
    assert _flat(got_tree) == _flat(want)
    assert tcommon.count_params(got_tree) == jcommon.count_params(want)


@pytest.mark.parametrize("arch,shape_id", GNN_CELLS)
def test_gnn_abstract_params_match_jax(arch, shape_id):
    jcfg, tcfg = _gnn_cfgs(arch, shape_id)
    want = jgm.abstract_params(jcfg)
    got = tgm.abstract_params(tcfg, device="cpu")
    assert _flat(got) == _flat(want)
    assert tcommon.count_params(got) == jcommon.count_params(want)


def test_abstract_params_on_fake_cuda_allocate_nothing():
    cfg = tconfigs.get_spec("h2o-danube-1.8b").config
    p = ttm.abstract_params(cfg, device="cuda", trainable=True)
    assert p.embed.device.type == "cuda" and p.embed.requires_grad
    assert fake.is_fake(p.layers["wq"])
    assert tcommon.count_params(p) == cfg.n_params()


@pytest.mark.parametrize("arch", [a for a in ARCHS if jconfigs.get_spec(a).family == "lm"])
def test_lm_input_specs_match_jax(arch):
    jcfg, tcfg = jconfigs.get_spec(arch).config, tconfigs.get_spec(arch).config
    for kind in ("train", "prefill", "decode"):
        for seq, batch in ((4096, 256), (32768, 128), (524288, 1)):
            assert (_flat(ttm.input_specs(tcfg, kind, seq, batch, device="cpu"))
                    == _flat(jtm.input_specs(jcfg, kind, seq, batch))), (kind, seq)


@pytest.mark.parametrize("arch,shape_id", GNN_CELLS)
def test_gnn_input_specs_match_jax(arch, shape_id):
    jcfg, tcfg = _gnn_cfgs(arch, shape_id)
    shape = jconfigs.get_spec(arch).shapes[shape_id]
    kind = shape["kind"]
    if kind == "minibatch":
        jcfg = dataclasses.replace(jcfg, fanouts=shape["fanouts"])
        tcfg = dataclasses.replace(tcfg, fanouts=shape["fanouts"])
    dims = {k: v for k, v in shape.items() if k != "kind"}
    assert (_flat(tgm.input_specs(tcfg, kind, device="cpu", **dims))
            == _flat(jgm.input_specs(jcfg, kind, **dims)))


def test_autoint_input_specs_match_jax():
    jcfg, tcfg = jconfigs.get_spec("autoint").config, tconfigs.get_spec("autoint").config
    for kind, batch, n in (("train", 65536, 0), ("serve", 512, 0),
                           ("retrieval", 1, 1_000_000)):
        assert (_flat(tai.input_specs(tcfg, kind, batch, n, device="cpu"))
                == _flat(jai.input_specs(jcfg, kind, batch, n_candidates=n)))


def test_sampled_input_shapes_match_jax():
    for b, fanouts, d in ((1024, (15, 10), 602), (7, (3,), 5), (2, (4, 3, 2), 16)):
        assert (_flat(tsampler.sampled_input_shapes(b, fanouts, d, device="cpu"))
                == _flat(jsampler.sampled_input_shapes(b, fanouts, d)))


# ---------------------------------------------------------------------------
# roofline


@pytest.mark.parametrize("mf", [None, 3.3e15])
def test_roofline_terms_match_jax(mf):
    hw = tanalysis.HW()
    jhw = janalysis.HW(peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw, link_bw=hw.link_bw,
                       hbm_bytes=hw.hbm_bytes)
    for args in ((1.2e15, 3.1e11, 2.0e9, 1), (5e12, 9.9e12, 4e10, 8), (0.0, 1.0, 1e12, 256)):
        assert tanalysis.roofline_terms(*args, hw, mf) == janalysis.roofline_terms(*args, jhw, mf)
    assert hw.peak_flops == 989e12 and hw.hbm_bw == 3.35e12 and hw.hbm_bytes == 80e9


def test_ring_formulas_match_jax():
    """One collective of each kind in HLO text, over groups of n devices;
    JAX parses each output's bytes, the port charges the same bytes."""
    kinds = ["all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"]
    for n in (2, 4, 8):
        group = "{" + ",".join(map(str, range(n))) + "}"
        lines = [f"  %c{i} = f32[{64 * (i + 1)},128] {k}(%p), replica_groups={{{group}}}"
                 for i, k in enumerate(kinds)]
        want = janalysis.collective_bytes_from_hlo("\n".join(lines), n)
        for i, kind in enumerate(kinds):
            got = tanalysis.ring_bytes(kind, 64 * (i + 1) * 128 * 4, n)
            assert got == want[kind], (kind, n)
    # COUNTS records inputs: an all-gather's is 1/n of its output, a
    # reduce-scatter's n times its output
    n, ins = 4, {"all_gather_bytes": 1000, "all_reduce_bytes": 3000, "reduce_scatter_bytes": 8000}
    got = tanalysis.collective_bytes_from_counts(ins, n)
    assert got["all-gather"] == tanalysis.ring_bytes("all-gather", 4000, n) == 3000
    assert got["all-reduce"] == tanalysis.ring_bytes("all-reduce", 3000, n) == 4500
    assert got["reduce-scatter"] == tanalysis.ring_bytes("reduce-scatter", 2000, n) == 6000
    assert got["total"] == 13500
    assert tanalysis.collective_bytes_from_counts(ins, 1)["total"] == 0


# ---------------------------------------------------------------------------
# against JAX's cells, in one subprocess

_JAX_CELLS = textwrap.dedent(r"""
    import functools, json, os, sys
    os.chdir(sys.argv[1])
    from repro.launch import dryrun as d  # sets XLA_FLAGS
    import jax
    from repro import configs
    from repro.dist import sharding as shd
    # the same abstract parameters for every shape of an arch
    d.tm.abstract_params = functools.cache(d.tm.abstract_params)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    out = {}
    shd.activate(mesh)
    try:
        with mesh:
            for arch in configs.all_arch_ids():
                spec = configs.get_spec(arch)
                maker = {"lm": d.lm_cell, "gnn": d.gnn_cell, "recsys": d.recsys_cell}[spec.family]
                for sid, shape in spec.shapes.items():
                    if not spec.skips.get(sid):
                        out[arch + "/" + sid] = maker(spec, sid, shape, mesh)[2]
    finally:
        shd.deactivate()
    d.palgol_partition_cell(8, 10)
    with open("model_flops.json", "w") as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_dryrun")
    proc = subprocess.run([sys.executable, "-c", _JAX_CELLS, str(tmp)], capture_output=True,
                          text=True, timeout=600,
                          env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src"),
                               "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    flops = json.loads((tmp / "model_flops.json").read_text())
    part = json.loads((tmp / "experiments/dryrun/palgol_partition.json").read_text())
    return flops, part


@pytest.mark.parametrize("arch,shape_id", CELLS)
def test_model_flops_match_jax(jax_cells, arch, shape_id):
    flops, _ = jax_cells
    if jconfigs.get_spec(arch).skips.get(shape_id):
        assert f"{arch}/{shape_id}" not in flops
        return
    assert dryrun.cell_model_flops(arch, shape_id) == flops[f"{arch}/{shape_id}"]


def test_palgol_partition_cell_matches_jax(jax_cells, tmp_path, capsys):
    _, want = jax_cells
    got = dryrun.palgol_partition_cell(8, 10, out_dir=tmp_path)
    assert json.loads(json.dumps(got)) == want
    assert json.loads((tmp_path / "palgol_partition.json").read_text()) == want


# ---------------------------------------------------------------------------
# the fake routes


def _route_counter(monkeypatch):
    """Counts each wrapper call of a real (plain, on the CPU) run by the
    route the wrapper's rules name, as ``dryrun.launch_counts`` keys it."""
    counts = {}

    def bump(name, route=None):
        for key in [f"{name}.launches"] + ([f"{name}.launches_{route}"] if route else []):
            counts[key] = counts.get(key, 0) + 1

    def wrap(mod, attr, rule):
        orig = getattr(mod, attr)

        def counted(*args, **kwargs):
            out = orig(*args, **kwargs)
            empty = (out[0] if isinstance(out, tuple) else out).numel() == 0
            if not empty:
                bump(*rule(*args, **kwargs))
            return out

        monkeypatch.setattr(mod, attr, counted)

    wrap(gather_ops, "gather_rows", lambda t, i, fill=None: (
        "gather_rows", gather_ops.route(int(np.prod(t.shape[1:])))))
    wrap(segment_ops, "segment_reduce", lambda v, *a, **k: (
        "segment_reduce", segment_ops.route(int(np.prod(v.shape[1:])))))
    wrap(segment_ops, "segment_reduce_bwd", lambda g, v, o, ids, n, op, *a, **k: (
        "segment_reduce_bwd", "sum" if op == "sum" else "ties"))
    wrap(flash_ops, "flash_attention", lambda q, *a, **k: (
        "flash_attention", flash_ops.route(q.dtype, q.shape[3])))
    wrap(flash_ops, "flash_attention_bwd", lambda q, *a, **k: (
        "flash_attention_bwd", flash_ops.bwd_route(q.dtype, q.shape[3])))
    wrap(bag_ops, "embedding_bag", lambda t, idx, *a, **k: (
        "embedding_bag", bag_ops.route(idx.shape[1], t.shape[1], t.dtype, 0)))
    wrap(scatter_ops, "scatter_rows", lambda *a, **k: ("scatter_rows",))
    return counts


def _as_launches(counts):
    return dryrun.launches_between({}, counts)


def _bf16(cfg):
    return dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")


def _lm_case(arch, kind):
    cfg = _bf16(tconfigs.get_spec(arch).reduced)
    b, s = 2, 40
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32)
    if kind == "train":
        params = ttm.init(cfg, 0, "cpu", trainable=True)
        oc = ttrain.AdamWConfig()
        opt = ttrain.adamw_init(params, oc)
        step = dryrun.train_step(lambda p, bb: ttm.loss_fn(p, bb, cfg), oc)
        return step, (params, opt, {"tokens": toks, "labels": toks})
    params = ttm.init(cfg, 0, "cpu")
    if kind == "prefill":
        return (lambda p, t: ttm.prefill(p, t, cfg, full_logits=False)), (params, toks)
    cache = ttm.init_cache(cfg, b, s, device="cpu")
    return (lambda p, c, t: ttm.decode_step_(p, c, t, cfg)), (params, cache, toks[:, :1])


def _gnn_case(arch):
    cfg = tconfigs.get_spec(arch).reduced
    spec, _, params, loss_fn, batches = ttrain.build(arch, True, 2, 8, 0, "cpu", config=cfg)
    oc = ttrain.AdamWConfig()
    opt = ttrain.adamw_init(params, oc)
    return dryrun.train_step(loss_fn, oc), (params, opt, batches(0))


def _autoint_case(kind):
    cfg = tconfigs.get_spec("autoint").reduced
    _, _, params, loss_fn, batches = ttrain.build("autoint", True, 16, 8, 0, "cpu")
    if kind == "train":
        oc = ttrain.AdamWConfig()
        return dryrun.train_step(loss_fn, oc), (params, ttrain.adamw_init(params, oc), batches(0))
    frozen = tcommon.map_tensors(params, lambda t: t.detach())
    return (lambda p, b: tai.forward(p, b, cfg)), (frozen, {"fields": batches(0)["fields"]})


CASES = {
    "h2o-prefill": lambda: _lm_case("h2o-danube-1.8b", "prefill"),
    "h2o-decode": lambda: _lm_case("h2o-danube-1.8b", "decode"),
    "h2o-train": lambda: _lm_case("h2o-danube-1.8b", "train"),
    "deepseek-moe-prefill": lambda: _lm_case("deepseek-moe-16b", "prefill"),
    "deepseek-moe-train": lambda: _lm_case("deepseek-moe-16b", "train"),
    "gat-cora-train": lambda: _gnn_case("gat-cora"),
    "pna-train": lambda: _gnn_case("pna"),
    "graphcast-train": lambda: _gnn_case("graphcast"),
    "autoint-serve": lambda: _autoint_case("serve"),
    "autoint-train": lambda: _autoint_case("train"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_launches_equal_the_routing_rules(case, monkeypatch):
    """The dry-run of a step launches, route by route, what the same step
    run for real names by the wrappers' route rules."""
    fn, args = CASES[case]()
    with monkeypatch.context() as m:
        counts = _route_counter(m)
        with torch.no_grad() if "train" not in case else torch.enable_grad():
            fn(*args)
    fn2, args2 = CASES[case]()
    rec = dryrun.trace(fn2, dryrun.fake_like(args2))
    assert rec["launches"] == _as_launches(counts)
    assert rec["launches"] or case == "h2o-decode", case  # dense decode: no kernel


def test_fake_outputs_have_the_plain_shapes():
    gen = torch.Generator().manual_seed(0)
    table = torch.randn((50, 3, 4), generator=gen)
    idx = torch.randint(-3, 60, (17,), generator=gen, dtype=torch.int32)
    vals = torch.randn((40, 6), generator=gen).to(torch.bfloat16)
    ids = torch.sort(torch.randint(0, 9, (40,), generator=gen, dtype=torch.int32)).values
    off = torch.searchsorted(ids, torch.arange(10, dtype=torch.int32), out_int32=True)
    q = torch.randn((1, 4, 33, 16), generator=gen).to(torch.bfloat16)
    k = torch.randn((1, 2, 33, 16), generator=gen).to(torch.bfloat16)
    bag_t = torch.randn((30, 16), generator=gen)
    bag_i = torch.randint(0, 30, (7, 3), generator=gen, dtype=torch.int32)
    calls = [
        (gather_ops.gather_rows, (table, idx), {"fill": 0.0}),
        (segment_ops.segment_reduce, (vals, ids, 9, "max"), {"offsets": off}),
        (segment_ops.segment_reduce_bwd,
         (torch.randn((9, 6)).to(torch.bfloat16), vals, torch.zeros((9, 6), dtype=torch.bfloat16),
          ids, 9, "min"), {"offsets": off}),
        (flash_ops.flash_attention, (q, k, k), {"window": 8, "return_lse": True}),
        (bag_ops.embedding_bag, (bag_t, bag_i, torch.ones((7, 3))), {}),
        (scatter_ops.scatter_rows, (ids, torch.arange(40), vals, 9), {}),
    ]
    for fn, args, kwargs in calls:
        want = fn(*args, **kwargs)
        fargs, fkwargs = dryrun.fake_like((args, kwargs))
        with tcommon.fake_mode(dryrun._leaves(fargs)):
            got = fn(*fargs, **fkwargs)
        for w, g in zip(want if isinstance(want, tuple) else (want,),
                        got if isinstance(got, tuple) else (got,)):
            assert fake.is_fake(g) and (g.shape, g.dtype) == (w.shape, w.dtype), fn.__name__
    out, lse = flash_ops.flash_attention(q, k, k, window=8, return_lse=True)
    fq, fk, fo, fl = dryrun.fake_like((q, k, out, lse))
    with tcommon.fake_mode([fq]):
        got = flash_ops.flash_attention_bwd(fq, fk, fk, fo, fl, fo, window=8)
    for w, g in zip(flash_ops.flash_attention_bwd(q, k, k, out, lse, out, window=8), got):
        assert (g.shape, g.dtype) == (w.shape, w.dtype)


def test_fake_work_is_the_bound():
    """The bound formulas: a ``scalar`` gather reads each distinct row once,
    flash's kept pairs × 4·D flops (× 10·D backward)."""
    fake.reset()
    with tcommon.fake_mode():
        table = torch.empty((100, 8))
        idx = torch.empty((30,), dtype=torch.int32)
        gather_ops.gather_rows(table, idx)
        q = torch.empty((2, 4, 64, 16), dtype=torch.bfloat16)
        k = torch.empty((2, 2, 64, 16), dtype=torch.bfloat16)
        flash_ops.flash_attention(q, k, k, causal=True, window=10)
    assert fake.WORK["gather_rows"] == {"launches": 1, "flops": 0.0,
                                        "bytes": 30 * 8 * 4 + 30 * 4 + 30 * 8 * 4}
    pairs = sum(min(i + 1, 10) for i in range(64))
    assert fake.kept_pairs(64, 64, True, 10) == pairs
    assert fake.WORK["flash_attention"]["flops"] == pairs * 2 * 4 * 4 * 16
    assert fake.kept_pairs(5, 7, False, None) == 35
    assert fake.kept_pairs(5, 7, False, 2) == sum(7 - max(0, i - 1) for i in range(5))


def test_real_cpu_tensors_never_take_the_fake_route():
    before = dryrun.launch_counts()
    out = gather_ops.gather_rows(torch.arange(6.0).reshape(3, 2), torch.tensor([2, 0],
                                                                             dtype=torch.int32))
    assert not fake.is_fake(out) and out.tolist() == [[4.0, 5.0], [0.0, 1.0]]
    assert dryrun.launch_counts() == before


# ---------------------------------------------------------------------------
# cells


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the dry-run built or loaded a kernel library")

    monkeypatch.setattr(build, "library", refuse)
    monkeypatch.setattr(build, "build", refuse)


@pytest.mark.parametrize("arch,shape_id", CELLS)
def test_reduced_cells_trace(arch, shape_id, no_build):
    rec = dryrun.dryrun_cell(arch, shape_id, "card", device="cpu", reduced=True)
    assert rec["status"] in ("ok", "skipped"), rec.get("traceback")
    if rec["status"] == "skipped":
        assert jconfigs.get_spec(arch).skips.get(shape_id)
        return
    m = rec["memory"]
    assert m["peak_per_device_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                                          + m["temp_bytes"] - m["alias_bytes"])
    assert m["peak_per_device_bytes"] >= m["argument_bytes"] > 0
    assert rec["cost"]["flops_per_device"] > 0 and rec["cost"]["bytes_per_device"] > 0
    spec = tconfigs.get_spec(arch)
    dense_decode = spec.family == "lm" and spec.reduced.moe is None and "decode" in (
        spec.shapes[shape_id]["kind"])
    assert bool(rec["launches"]) is not dense_decode  # its attention is plain tensor code
    if jconfigs.get_spec(arch).shapes[shape_id]["kind"] not in ("prefill", "serve",
                                                                 "retrieval"):
        # the parameters and moments (or the cache) updated in place
        assert 0 < m["alias_bytes"] <= m["argument_bytes"]
    json.dumps(rec)


@pytest.mark.parametrize("arch,shape_id,fits", [
    ("h2o-danube-1.8b", "prefill_32k", True),
    ("gat-cora", "full_graph_sm", True),
])
def test_full_width_cells(arch, shape_id, fits, no_build):
    rec = dryrun.dryrun_cell(arch, shape_id, "card", device="cpu")
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["fits"] is fits
    assert rec["model_flops"] == dryrun.cell_model_flops(arch, shape_id)
    if arch == "h2o-danube-1.8b":
        # 24 layers, each one flash launch on the tensor cores
        assert rec["launches"] == {"flash_attention": {"all": 24, "tc": 24}}
        # bf16 weights and int32 tokens
        assert rec["memory"]["argument_bytes"] == (
            2 * tconfigs.get_spec(arch).config.n_params() + 4 * 32 * 32768)


def test_cli_writes_records(tmp_path, no_build, capsys):
    assert dryrun.main(["--arch", "autoint", "--mesh", "card", "--device", "cpu",
                        "--reduced", "--out", str(tmp_path)]) == 0
    recs = sorted((tmp_path / "card").glob("autoint__*.json"))
    assert len(recs) == 4
    assert all(json.loads(p.read_text())["status"] == "ok" for p in recs)
    assert "done: ok=4 failed=0 skipped=0" in capsys.readouterr().out


def test_trace_reads_and_restores_the_counters(monkeypatch):
    """The fake launches advance the wrappers' counters, the trace reads its
    launches from them, then sets each back: a path's own counts stay the
    card's."""
    monkeypatch.setattr(gather_ops.gather_rows, "launches", 7)
    monkeypatch.setattr(gather_ops.gather_rows, "launches_scalar", 3)
    before = dryrun.launch_counts()
    table = torch.randn((10, 4))
    idx = torch.tensor([1, 2, 3], dtype=torch.int32)
    rec = dryrun.trace(lambda t, i: gather_ops.gather_rows(t, i), dryrun.fake_like((table, idx)))
    assert rec["launches"] == {"gather_rows": {"all": 1, "scalar": 1}}
    assert rec["kernels"]["gather_rows"]["launches"] == 1
    assert dryrun.launch_counts() == before


def test_microbatch_accumulation_is_the_whole_batch():
    """JAX's rule (each microbatch's loss and gradient over ``micro``,
    summed): with a token-mean loss and equal microbatches it is the
    whole batch's loss and gradient, in f32 to rounding."""
    cfg = tconfigs.get_spec("h2o-danube-1.8b").reduced
    params = ttm.init(cfg, 0, "cpu", trainable=True)
    toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks.roll(-1, dims=1)}

    def loss_fn(p, b):
        return ttm.loss_fn(p, b, cfg)

    want_loss, want = ttrain.value_and_grad(loss_fn, params, batch)
    got_loss, got = ttrain.accumulate(loss_fn, params, batch, 2)
    assert abs(float(got_loss) - float(want_loss)) <= 1e-6 * abs(float(want_loss))
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], w, rtol=0, atol=1e-5 * float(w.abs().max()))
