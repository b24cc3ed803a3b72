"""The trainer's live state held as FSDP shards, against the JAX package's
layout, and the dry-run's pod meshes, on the CPU.

* shards: for every arch, at full width (``abstract_params``) and reduced,
  on ``(4, 1)`` and the dry-run's ``single`` (16 × 16) and ``multi``
  (2 × 16 × 16) meshes, in ``fsdp`` and (LMs) ``zero1`` mode, each leaf's
  shard shape under the port's spec equals JAX's ``NamedSharding.
  shard_shape`` under JAX's rule on the same mesh; for the reduced
  parameters the slices of every rank put back together give the leaf,
  each element once;
* 4 gloo ranks (``tests/torch_fsdp_ranks.py``, one subprocess): each
  rank's live parameters and moments are its shards only, their bytes the
  sum of JAX's shard shapes; a stop and a failed restart replay bit-equal
  to an uninterrupted run; the sharded run's checkpoint restores in the
  one-rank trainer and in JAX's ``restore_checkpoint`` (float32 leaves:
  JAX's restore rejects its own bfloat16 ones, ROADMAP §C), and a
  one-rank checkpoint in the sharded trainer; the clipping norm on shards
  equals the whole gradient's, for a gradient large enough to clip;
* ``dryrun_cell`` on ``single`` and ``multi`` for reduced configs of the
  three families: ``ok``, the argument bytes those of the rank's shards
  and its share of the batch, its collectives counted.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh, NamedSharding as JNamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import checkpoint as jck  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.gnn import models as jgm  # noqa: E402
from repro.models.recsys import autoint as jai  # noqa: E402
from repro.models.transformer import model as jtm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.checkpoint import _flatten  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as tr  # noqa: E402
from repro_torch.models.gnn import models as gm  # noqa: E402
from repro_torch.models.recsys import autoint  # noqa: E402
from repro_torch.models.transformer import model as tm  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
import torch_fsdp_ranks as ranks  # noqa: E402

MESHES = {"4x1": ((4, 1), ("data", "model")), **{k: dryrun.MESHES[k]
                                                  for k in ("single", "multi")}}
MODELS = {"lm": (tm, jtm), "gnn": (gm, jgm), "recsys": (autoint, jai)}


def _gnn_bound(spec, cfg):
    """A GNN config with its dims bound (the published ones leave them
    open), as the dry-run binds them at ``full_graph_sm``."""
    return configs.resolve_gnn_config(cfg, "full_graph_sm", spec.shapes["full_graph_sm"])


@functools.lru_cache(maxsize=None)
def _trees(arch, full):
    """``(port params tree, JAX abstract params)`` of an arch's full or
    reduced config, both in the JAX nesting."""
    spec, jspec = configs.get_spec(arch), jconfigs.get_spec(arch)
    cfg, jcfg = (spec.config, jspec.config) if full else (spec.reduced, jspec.reduced)
    if spec.family == "gnn":
        cfg = _gnn_bound(spec, cfg)
        jcfg = jconfigs.resolve_gnn_config(jcfg, "full_graph_sm", jspec.shapes["full_graph_sm"])
    port, jmod = MODELS[spec.family]
    params = port.abstract_params(cfg, "cpu") if full else port.init(cfg, 0, "cpu")
    return tr.params_tree(params), jmod.abstract_params(jcfg), spec.family


SHARD_CASES = [(arch, full, mesh) for arch in configs.all_arch_ids()
               for full in (True, False) for mesh in MESHES]


@pytest.mark.parametrize("arch,full,mesh", SHARD_CASES)
def test_shards_are_jax_shard_shapes(arch, full, mesh):
    """Each leaf's slice under the port's spec has JAX's ``shard_shape``
    under JAX's spec for it; the reduced leaves come back whole from every
    rank's slice, each element once."""
    shape, axes = MESHES[mesh]
    pmesh = shd.Mesh(dict(zip(axes, shape)), device="cpu")
    jmesh = AbstractMesh(shape, axes)
    ptree, jtree, family = _trees(arch, full)
    modes = ("fsdp", "zero1") if family == "lm" else ("fsdp",)
    for mode in modes:
        pspecs = dict(_flatten(shd.param_shardings(family, ptree, pmesh, mode)))
        jspecs = dict(_flatten(jax.tree_util.tree_map(
            lambda s: s.spec, jshd.param_shardings(family, jtree, jmesh, mode=mode),
            is_leaf=lambda x: isinstance(x, JNamedSharding))))
        leaves = dict(_flatten(ptree))
        assert pspecs.keys() == leaves.keys()
        for k, leaf in leaves.items():
            want = JNamedSharding(jmesh, jspecs[k]).shard_shape(tuple(leaf.shape))
            assert shd.shard_shape(leaf.shape, pspecs[k]) == want, (mode, k)
            if full:
                continue
            # the ranks that differ on the axes the spec names (the others
            # hold the same slices): their slices cover the leaf once
            named = {a for _, names in shd.sharded_dims(pspecs[k]) for a in names}
            cover = torch.zeros(leaf.shape, dtype=torch.int32)
            back = torch.zeros_like(leaf)
            for c in np.ndindex(*[n if a in named else 1 for a, n in zip(axes, shape)]):
                sl = shd._local_slices(leaf.shape, pspecs[k], c)
                part = shd.shard_of(leaf, pspecs[k], c)
                assert tuple(part.shape) == want
                back[sl] = part
                cover[sl] += 1
            assert torch.equal(back, leaf) and bool((cover == 1).all()), k


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """The 4 gloo ranks' results, and the one-rank runs beside them."""
    out = tmp_path_factory.mktemp("fsdp")
    one = ranks.trainer(out / "one", total=ranks.STEPS)
    one.run(ranks.STOP)
    one_state = ranks.whole_state(one)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, str(HERE / "torch_fsdp_ranks.py"), str(out)],
                          capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    return dict(np.load(out / "ranks.npz")), one_state, out


def _whole(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def test_live_state_is_the_ranks_shards(rank_results):
    """Every rank's live parameters and moments are its shards only: each
    leaf of JAX's ``shard_shape`` under the FSDP spec on (4, 1), the bytes
    their sum — about a quarter of the whole state's."""
    res, _, _ = rank_results
    _, jtree, _ = _trees(ranks.ARCH, False)
    jmesh = AbstractMesh((4, 1), ("data", "model"))
    jspec = dict(_flatten(jax.tree_util.tree_map(
        lambda s: s.spec, jshd.param_shardings("lm", jtree, jmesh),
        is_leaf=lambda x: isinstance(x, JNamedSharding))))
    whole = sum(v.nbytes for k, v in _whole(res, "state/whole/").items())
    for r in range(4):
        shapes = _whole(res, f"rank{r}/state/shape/")
        total = 0
        for k, got in shapes.items():
            if k == "opt/step":
                total += 4
                continue
            leaf = k.split("/", 2)[-1] if k.startswith("opt/") else k[len("params/"):]
            full = res[f"state/whole/{k}"]
            want = JNamedSharding(jmesh, jspec[leaf]).shard_shape(full.shape)
            assert tuple(got) == want, (r, k)
            total += int(np.prod(want)) * full.itemsize
        assert int(res[f"rank{r}/state/bytes"]) == total
        assert total < 0.35 * whole
    assert len(res["state/held"]) > 0


def test_stop_and_failed_restart_replay_bit_equal(rank_results):
    """A job stopped after 2 steps and a restart that fails once at step 3
    (restoring the newest checkpoint: each rank its slice) end in the
    uninterrupted sharded run's state, bit for bit; each step's last loss
    equal to its."""
    res, _, _ = rank_results
    assert int(res["replay/retries"]) == 1
    last = {int(s): l for s, l in res["replay/losses"]}
    assert last == {int(s): l for s, l in res["state/losses"]}
    want, got = _whole(res, "state/whole/"), _whole(res, "replay/whole/")
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_checkpoint_restores_across_rank_counts(rank_results):
    """The sharded run's last checkpoint (whole arrays, rank 0's) restores
    in the one-rank trainer and in JAX's ``restore_checkpoint``, bit-equal
    to the sharded state gathered whole; the one-rank trainer's checkpoint
    restores in the sharded trainer, each rank taking its slice."""
    res, one_state, out = rank_results
    want = _whole(res, "state/whole/")
    one = ranks.trainer(out / "sharded")
    one.run(ranks.STEPS)  # resumes at the last step: nothing to run
    assert one.losses == []
    for k, v in ranks.whole_state(one).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    _, _, jp, _, _ = jtrain.build(ranks.ARCH, True, ranks.BATCH, ranks.SEQ, 0)
    jstate = {"params": jp, "opt": jadamw.adamw_init(jp, jadamw.AdamWConfig())}
    restored, step, _ = jck.restore_checkpoint(out / "sharded", jstate)
    assert step == ranks.STEPS
    for k, v in _flatten(jax.tree_util.tree_map(np.asarray, restored)):
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert int(res["resume/steps_run"]) == 0
    for k, v in _whole(res, "resume/whole/").items():
        np.testing.assert_array_equal(v, one_state[k], err_msg=k)


def test_clip_norm_on_shards_is_the_whole_gradients(rank_results):
    """With a gradient far past the clip (norm ~10³ against 1.0), the norm
    summed over the shards' groups equals the whole gradient's, where a
    rank's own shards give another; AdamW's clipped update of the shards
    equals the whole update's slices."""
    res, _, _ = rank_results
    whole = float(res["clip/norm_whole"])
    assert whole > 100.0
    np.testing.assert_allclose(float(res["clip/norm_shards"]), whole, rtol=1e-6)
    assert abs(float(res["clip/norm_local"]) - whole) > 1e-3 * whole
    assert float(res["clip/update_max_diff"]) <= 1e-7


def test_expert_parallel_on_the_data_parallel_step(rank_results):
    """The reduced deepseek-moe on (2, 2), rows over ``data``, experts over
    ``model``: each rank holds 4 of the 8 experts' stacks (half their
    rows), its loss that of its rows through the whole parameters, the
    gradients (gathered whole) those averaged over the data ranks."""
    res, _, _ = rank_results
    assert tuple(res["ep/expert_shape"]) == (2, 4, 32, 32)
    assert int(res["ep/routed_here"]) > 0
    assert float(res["ep/loss_diff"]) <= 1e-6
    assert float(res["ep/grad_rel_diff"]) <= 1e-5


DRY_CELLS = [("h2o-danube-1.8b", "train_4k"), ("h2o-danube-1.8b", "decode_32k"),
             ("deepseek-moe-16b", "train_4k"), ("deepseek-moe-16b", "decode_32k"),
             ("gat-cora", "full_graph_sm"), ("autoint", "train_batch")]


def _arg_bytes(arch, shape_id, mesh_kind):
    """The bytes rank 0 holds for a reduced cell on the mesh, from the
    rules and ``shard_shape``: its parameters (``PARAM_MODE``), moments
    (``fsdp``) and step, and its rows of the batch (or all of them; a
    GNN's block of each leaf by ``batch_shardings``); a
    LM's decode cache (dense or MoE) its ``C / model`` slots, as JAX's
    ``lm_cache_spec`` splits the cache's sequence."""
    spec = configs.get_spec(arch)
    shape = spec.shapes[shape_id]
    mshape, axes = dryrun.MESHES[mesh_kind]
    mesh = shd.Mesh(dict(zip(axes, mshape)), device="cpu")
    cfg = spec.reduced
    if spec.family == "gnn":
        cfg = _gnn_bound(spec, cfg)
    params = {"lm": lambda: tm.abstract_params(cfg, "cpu"),
              "gnn": lambda: gm.abstract_params(cfg, "cpu"),
              "recsys": lambda: autoint.abstract_params(cfg, "cpu")}[spec.family]()
    tree = tr.params_tree(params)
    mode = dryrun.PARAM_MODE.get((arch, shape_id), "fsdp")

    def held(m, itemsize=None):
        return sum(int(np.prod(shd.shard_shape(t.shape, sh))) * (itemsize or t.element_size())
                   for (_, t), (_, sh) in zip(_flatten(tree), _flatten(
                       shd.param_shardings(spec.family, tree, mesh, m))))

    total = held(mode)
    kind = shape["kind"]
    batch = shape.get("global_batch", shape.get("batch"))
    n = int(np.prod([mesh.shape[a] for a in tr.batch_axes(spec.family, mesh)]))
    rows = batch // n if spec.family != "gnn" and batch % n == 0 else batch
    if kind == "train" or spec.family == "gnn":  # a GNN cell is a train step
        total += 2 * held("fsdp", 4) + 4  # float32 moments, the int32 step
    if spec.family == "lm":
        specs = tm.input_specs(cfg, kind, shape["seq_len"], rows, "cpu")
        if kind == "decode":
            kv = specs["cache"]["k"]
            cache = shd.lm_cache_spec(mesh, cfg, kv.shape[1], kv.shape[2])
            assert cache[2] == "model"
            for part in ("k", "v"):
                specs["cache"][part] = torch.empty(
                    kv.shape[:2] + (kv.shape[2] // mesh.shape["model"],) + kv.shape[3:],
                    dtype=kv.dtype, device="meta")
    elif spec.family == "recsys":
        specs = autoint.input_specs(cfg, kind, rows, device="cpu")
    else:
        n_nodes, n_edges = dryrun.gnn_graph_size(shape)
        specs = gm.input_specs(cfg, "full_graph", "cpu", n_nodes=n_nodes, n_edges=n_edges,
                               d_feat=shape["d_feat"])
        # each leaf's block under batch_shardings("gnn"): its rows over every axis
        bshard = shd.batch_shardings("gnn", specs, mesh)
        return total + sum(int(np.prod(shd.shard_shape(t.shape, bshard[k]))) * t.element_size()
                           for k, t in specs.items())
    return total + sum(t.numel() * t.element_size() for _, t in _flatten(specs))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("arch,shape_id", DRY_CELLS)
def test_dryrun_pod_mesh_cells(arch, shape_id, mesh_kind):
    """A reduced cell on a pod mesh traces rank 0's step: ``ok``, the
    argument bytes those of its shards and batch rows, its collectives
    counted, and the per-rank peak and fit recorded."""
    rec = dryrun.dryrun_cell(arch, shape_id, mesh_kind, "cpu", reduced=True)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == int(np.prod(dryrun.MESHES[mesh_kind][0]))
    assert rec["memory"]["argument_bytes"] == _arg_bytes(arch, shape_id, mesh_kind)
    assert rec["collectives"]["total"] > 0
    assert rec["memory"]["peak_per_device_bytes"] >= rec["memory"]["argument_bytes"]
    assert isinstance(rec["memory"]["fits"], bool)


def test_dryrun_refuses_unknown_meshes():
    with pytest.raises(ValueError):
        dryrun.dryrun_cell("gat-cora", "full_graph_sm", "pod", "cpu", reduced=True)
