"""The port's models on a mesh: 4 gloo ranks on the CPU.

    python tests/torch_mesh_ranks.py OUT_DIR

Helper of ``tests/test_torch_mesh.py`` (not a test module itself: it
imports only ``torch``, numpy and the port, never ``jax``). It reads
``OUT_DIR/inputs.npz`` (``tests/torch_mesh_reference.py``'s
``make_inputs``), runs on the ``("data", "model") = (2, 2)`` mesh what the
reference runs under JAX's — the ``mp_*`` ops, the fused GNN layers,
``moe_ffn``, the reduced GNN forwards and MoE prefill — then two
``launch.train.Supervised`` steps of the reduced gat-cora and deepseek-moe
on ``make_train_mesh``'s ``(4, 1)``, and writes rank 0's results (every
DTensor gathered whole) to ``OUT_DIR/torch.npz``. Besides the results it
records, per rank, that each region's offsets are those of its own rows
and that every rank computed the same replicated values.

A rank that raises makes ``torch.multiprocessing.spawn`` raise, so the
script exits non-zero.
"""

from __future__ import annotations

import os
import socket
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

import torch_mesh_reference as ref  # noqa: E402  (numpy only at import)

WORLD = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _t(arr, grad=False):
    t = torch.from_numpy(np.array(arr))
    return t.requires_grad_(True) if grad else t


def _full(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().numpy()


def _tree(a, prefix):
    from repro_torch.models.common import tensors_from_arrays

    return tensors_from_arrays(ref.unflat(a, prefix), torch.device("cpu"))


def _replicated(name, t, res):
    """Every rank must hold the same replicated value: rank 0 records
    whether they do."""
    mine = torch.as_tensor(_full(t)).float().reshape(-1)
    lo, hi = mine.clone(), mine.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    res[f"same/{name}"] = np.asarray(bool(torch.equal(lo.nan_to_num(), hi.nan_to_num())))


def mp_cases(a, res):
    from repro_torch.graph import ops as gops
    from repro_torch.graph.structure import segment_offsets

    n = ref.N_NODES
    w_nodes = _t(a["w_nodes"])
    for tag in ref.EDGES:
        src, dst, mask = (_t(a[f"{tag}/{k}"]) for k in ("src", "dst", "mask"))
        off = segment_offsets(dst, n)
        region = gops._region(dst.shape[0])
        res[f"offsets/{tag}/{dist.get_rank()}"] = np.asarray(torch.equal(
            region.offsets(off), segment_offsets(region.rows(dst, n), n)))
        vals = {"f": a[f"{tag}/vf"], "p": a[f"{tag}/vp"], "i": a[f"{tag}/vi"],
                "b": a[f"{tag}/vb"]}
        for kind, ops in (("f", ("sum", "max", "min")), ("p", ("prod",)),
                          ("i", ("sum", "max", "min")), ("b", ("or", "and"))):
            for op in ops:
                out = gops.mp_segment_reduce(_t(vals[kind]), dst, n, op, mask=mask,
                                             offsets=off)
                res[f"mp/{tag}/seg_{op}_{kind}"] = _full(out)
                _replicated(f"mp/{tag}/seg_{op}_{kind}", out, res)
        for op in ("sum", "max", "min"):
            v = _t(vals["f"], grad=True)
            r = gops.mp_segment_reduce(v, dst, n, op, mask=mask, offsets=off)
            (torch.where(torch.isfinite(r), r, 0.0) * w_nodes).sum().backward()
            res[f"mp/{tag}/grad_{op}"] = v.grad.numpy()
        field = _t(a["field"], grad=True)
        w_e = _t(a[f"{tag}/w_edges"][:, :3])
        out = gops.mp_gather(field, src)
        res[f"mp/{tag}/gather_clip"] = _full(out)
        res[f"mp/{tag}/gather_fill"] = _full(gops.mp_gather(field, src, fill=-7.0))
        # each rank's loss over its own edge rows: their sum is the global loss
        local = out.to_local()
        (local * w_e[region.start:region.start + local.shape[0]]).sum().backward()
        res[f"mp/{tag}/grad_gather"] = field.grad.numpy()
        scores = _t(a[f"{tag}/scores"], grad=True)
        sm = gops.mp_edge_softmax(scores, dst, n, mask=mask, offsets=off)
        res[f"mp/{tag}/softmax"] = _full(sm)
        local = sm.to_local()
        (local * w_e[region.start:region.start + local.shape[0], :2]).sum().backward()
        res[f"mp/{tag}/grad_softmax"] = scores.grad.numpy()


def constrain_cases(res):
    """``constrain`` on the (2, 2) mesh: a DTensor laid out anew by each
    spec (indivisible entries dropped) holds the same values; a plain
    tensor constrained to rows over every axis becomes this rank's block,
    to any other spec stays as it is; a region's edge rows stay split
    where the mesh divides them and are gathered whole where it does not."""
    from repro_torch.dist import sharding as shd
    from repro_torch.graph import ops as gops

    mesh = shd.active_mesh()
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    d = shd.device_put(x, shd.NamedSharding(mesh, shd.P("data", None)))
    for i, axes in enumerate([(None, "model"), (shd.ALL, None), (shd.BATCH, "model"),
                              ("model", "data"), (None, None), (None, ("data", "model"))]):
        out = shd.constrain(d, axes)
        want = shd._maybe(shd._resolve(axes, mesh), x.shape, mesh)
        res[f"constrain/{i}"] = np.asarray(
            torch.equal(torch.from_numpy(_gather(out)), x)
            and shd.spec_of(out) == want)
    # a plain tensor constrained to ALL rows: this rank's block (a flat
    # DTensor), the values kept; to another spec, itself
    rows = shd.constrain(x, (shd.ALL, None))
    r = dist.get_rank()
    res["constrain/plain"] = np.asarray(
        shd.is_flat(rows) and torch.equal(rows.to_local(), x[2 * r:2 * r + 2])
        and torch.equal(torch.from_numpy(_gather(rows)), x)
        and shd.constrain(x, (None, "model")) is x)
    # a region's edge rows: kept where the mesh divides them, else gathered
    # whole (JAX's _maybe leaves 257 rows replicated)
    e = gops.edge_sharded(torch.ones(256, 3))
    ragged = gops.edge_sharded(torch.ones(257, 3))
    whole = [shd.constrain(ragged, axes) for axes in ((shd.ALL, None), (None, "model"))]
    res["constrain/edges"] = np.asarray(
        shd.constrain(e, (shd.ALL, None)) is e
        and all(not shd.is_flat(w) and torch.equal(w, torch.ones(257, 3)) for w in whole))


def _gather(t):
    from repro_torch.dist import collectives

    return collectives.full_tensor(t).numpy()


def _grads(params, prefix, res):
    from repro_torch.optim import named_leaves

    for name, p in named_leaves(params).items():
        res[f"{prefix}/{name}"] = p.grad.numpy()


def layer_cases(a, res):
    from repro_torch.dist import sharding as shd
    from repro_torch.graph import ops as gops
    from repro_torch.graph.structure import segment_offsets
    from repro_torch.models.common import trainable
    from repro_torch.models.gnn import layers as L

    n = ref.N_NODES
    w_x = _t(a["w_x"])
    for tag in ref.EDGES:
        src, dst, mask = (_t(a[f"{tag}/{k}"]) for k in ("src", "dst", "mask"))
        src = src.clamp(0, n - 1)
        off = segment_offsets(dst, n)
        w_e = _t(a[f"{tag}/w_edges"])
        p, x = trainable(_tree(a, "pna_p")), _t(a["x"], grad=True)
        out = L.pna_layer_fused(p, x, src, dst, mask, n, ref.PNA_AGGS, ref.PNA_SCALERS,
                                ref.PNA_DELTA, offsets=off)
        res[f"pna/{tag}/out"] = _full(out)
        _replicated(f"pna/{tag}/out", out, res)
        # the rank's node rows gathered whole, every rank the whole loss
        (shd.whole(out) * w_x).sum().backward()
        _grads(p, f"pna/{tag}/grad_p", res)
        res[f"pna/{tag}/grad_x"] = x.grad.numpy()

        p, x = trainable(_tree(a, "mpnn_p")), _t(a["x"], grad=True)
        e = _t(a[f"{tag}/e_feat"], grad=True)
        xn, en = L.mpnn_layer_fused(p, x, e, src, dst, mask, n, offsets=off)
        res[f"mpnn/{tag}/x"], res[f"mpnn/{tag}/e"] = _full(xn), _full(en)
        if shd.is_flat(en):  # each rank's loss over its own edge rows
            local = en.to_local()
            start = gops._region(dst.shape[0]).start
            e_loss = (local * w_e[start:start + local.shape[0]]).sum()
        else:  # whole on every rank (257 rows), as the node term
            e_loss = (en * w_e).sum()
        ((shd.whole(xn) * w_x).sum() + e_loss).backward()
        _grads(p, f"mpnn/{tag}/grad_p", res)
        res[f"mpnn/{tag}/grad_x"], res[f"mpnn/{tag}/grad_e"] = x.grad.numpy(), e.grad.numpy()
    src, dst, mask = (_t(a[f"e256/{k}"]) for k in ("src", "dst", "mask"))
    m = 94
    x = _t(a["x"])[:m]
    for name, fn in (
        ("pna", lambda: L.pna_layer_fused(_tree(a, "pna_p"), x, src.clamp(0, m - 1),
                                          dst.clamp(max=m), mask, m, ref.PNA_AGGS,
                                          ref.PNA_SCALERS, ref.PNA_DELTA)),
        ("mpnn", lambda: L.mpnn_layer_fused(_tree(a, "mpnn_p"), x, _t(a["e256/e_feat"]),
                                            src.clamp(0, m - 1), dst.clamp(max=m), mask, m)),
    ):
        try:
            fn()
            res[f"{name}/n94_error"] = np.asarray("")
        except ValueError as err:
            res[f"{name}/n94_error"] = np.asarray(str(err))


def moe_cases(a, res):
    from repro_torch.models.common import trainable
    from repro_torch.models.transformer import moe as tmoe
    from repro_torch.models.transformer.config import MoEConfig

    mcfg = MoEConfig(**ref.MOE)
    p, x = trainable(_tree(a, "moe_p")), _t(a["moe/x"], grad=True)
    slots, dropped = tmoe.moe_ffn.slots, tmoe.moe_ffn.dropped
    y, aux = tmoe.moe_ffn(x, p, mcfg)
    res["moe/y"], res["moe/aux"] = _full(y), _full(aux)
    _replicated("moe/y", y, res)
    res[f"moe/dropped/{dist.get_rank()}"] = np.asarray(
        [tmoe.moe_ffn.slots - slots, int(tmoe.moe_ffn.dropped - dropped)])
    ((y * _t(a["moe/w_y"])).sum() + aux).backward()
    _grads(p, "moe/grad_p", res)
    res["moe/grad_x"] = x.grad.numpy()


def model_cases(a, res):
    from repro_torch import configs
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as shd
    from repro_torch.models.gnn import models as gm
    from repro_torch.models.transformer import model as tm

    for arch in ref.GNN_ARCHS:
        cfg = _gnn_cfg(arch)
        params = gm.params_from_arrays(cfg, ref.unflat(a, f"gnn/{arch}/params"), "cpu")
        batch = _tree(a, f"gnn/{arch}/batch")
        with torch.no_grad():
            out = gm.forward(params, batch, cfg)
        res[f"gnn/{arch}/out"] = _full(out)
        _replicated(f"gnn/{arch}/out", out, res)
    lm = configs.get_spec("deepseek-moe-16b").reduced
    params = tm.params_from_arrays(lm, ref.unflat(a, "lm/params"), "cpu")
    logits, _ = tm.prefill(params, _t(a["lm/tokens"]), lm)
    # tensor-parallel over model: the rank's vocabulary block, gathered whole
    logits = coll.all_gather_dim(logits, 2, shd.model_axis().group)
    res["lm/logits"] = _full(logits)
    _replicated("lm/logits", logits, res)


def _gnn_cfg(arch):
    from repro_torch import configs

    spec = configs.get_spec(arch)
    return configs.resolve_gnn_config(spec.reduced, "full_graph_sm", {
        "n_nodes": 64, "n_edges": 512, "d_feat": spec.reduced.d_in})


def train_cases(a, res, ckpt_root):
    import json

    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch.train import Supervised
    from repro_torch.models.gnn import models as gm
    from repro_torch.models.recsys import autoint
    from repro_torch.models.transformer import model as tm
    from repro_torch.optim import AdamWConfig

    oc = AdamWConfig(lr=ref.TRAIN_LR)
    for case in ref.TRAIN_ARCHS:
        arch, rows = ref.train_case(case)
        if arch == "gat-cora":
            cfg, family = _gnn_cfg(arch), "gnn"
            params = gm.params_from_arrays(cfg, ref.unflat(a, f"gnn/{arch}/params"), "cpu",
                                           trainable=True)
            batches = [_tree(a, f"gnn/{arch}/batch")] * ref.TRAIN_STEPS

            def loss_fn(p, b, cfg=cfg):
                return gm.loss_fn(p, b, cfg)
        else:
            cfg = configs.get_spec(arch).reduced
            family = "recsys" if arch == "autoint" else "lm"
            model = autoint if family == "recsys" else tm
            params = model.params_from_arrays(cfg, ref.unflat(a, ref.train_params_key(arch)),
                                              "cpu", trainable=True)
            batches = [{k: v[:rows] for k, v in _tree(a, f"train/{arch}/batch{i}").items()}
                       for i in range(ref.TRAIN_STEPS)]

            def loss_fn(p, b, cfg=cfg, model=model):
                return model.loss_fn(p, b, cfg)
        ckpt_dir = os.path.join(ckpt_root, case)
        run = Supervised(family, params, loss_fn, lambda i: batches[i], oc,
                         warmup=ref.TRAIN_WARMUP, total=ref.TRAIN_STEPS,
                         ckpt_dir=ckpt_dir, device="cpu", log=lambda line: None)
        run.run(ref.TRAIN_STEPS)
        res[f"train/{case}/losses"] = np.asarray([x for _, x in run.losses], np.float32)
        res[f"train/{case}/on_mesh"] = np.asarray(run.on_mesh)
        res[f"train/{case}/held"] = np.asarray(sorted(run.shards.params))
        state = run.tree()
        for part, tree in (("params", state["params"]), ("m", state["opt"]["m"])):
            for k, v in _leaves(tree):
                sh = run.shardings.get(f"{'opt/m' if part == 'm' else 'params'}/{k}")
                res[f"train/{case}/{part}/{k}"] = _full(v if sh is None else shd.unshard(v, sh))
        # the checkpoint's layout: the parameters FSDP-sharded as JAX places them
        step_dir = os.path.join(ckpt_dir, f"step_{latest_step(ckpt_dir):08d}")
        with open(os.path.join(step_dir, "manifest.json")) as f:
            keys = json.load(f)["keys"]
        res[f"train/{case}/sharded"] = np.asarray(sum(
            k.startswith("params/") and "data" in meta["spec"] for k, meta in keys.items()))


def _leaves(tree):
    from repro_torch.checkpoint.checkpoint import _flatten

    return _flatten(tree)


def _rank(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        from repro_torch.dist import sharding as shd
        from repro_torch.launch.mesh import make_mesh

        a = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        res = {}
        shd.activate(make_mesh((2, 2), ("data", "model"), device="cpu"))
        try:
            constrain_cases(res)
            mp_cases(a, res)
            layer_cases(a, res)
            moe_cases(a, res)
            model_cases(a, res)
        finally:
            shd.deactivate()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = [tmp]
            dist.broadcast_object_list(ckpt, src=0)  # one directory for every rank
            train_cases(a, res, ckpt[0])
            dist.barrier()
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, {k: v for k, v in res.items()
                                          if k.startswith(("offsets/", "moe/dropped/"))})
        if rank == 0:
            for g in gathered:
                res.update(g)
            np.savez(os.path.join(out_dir, "torch.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(_free_port(), sys.argv[1]), nprocs=WORLD)
