"""The port's GNNs with their nodes and edges split over every rank: 4 gloo
ranks on the CPU.

    python tests/torch_gnn_shard_ranks.py OUT_DIR

Helper of ``tests/test_torch_gnn_shard.py`` (not a test module itself: it
imports only ``torch``, numpy and the port, never ``jax``). It reads
``OUT_DIR/inputs.npz`` (``tests/torch_gnn_shard_reference.py``'s
``make_inputs``) and runs on each mesh of the reference what it runs
under JAX's, each rank holding its block of the batch
(``launch.train.shard_graph``): the forward's output and the first
layer's ``h`` (and GraphCast's ``e``) as this rank's rows, the loss and
the parameters' gradients, the fused layers' ``ValueError`` at 94 nodes;
then two ``launch.train.Supervised`` steps of the reduced gat-cora on
``(4, 1)``. Besides the results each rank records the layout it held:
the local shape of every batch leaf, of ``h`` and ``e`` and of the
output, and every plain tensor of ``N`` or ``E`` rows alive at a layer's
entry (none where the mesh divides them). Rank 0 writes everything to
``OUT_DIR/torch.npz``, each rank's own keys ending in its rank.

A rank that raises makes ``torch.multiprocessing.spawn`` raise, so the
script exits non-zero.
"""

from __future__ import annotations

import contextlib
import gc
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

import torch_gnn_shard_reference as ref  # noqa: E402  (numpy only at import)
from torch_mesh_reference import unflat  # noqa: E402

WORLD = 4
#: the layer functions whose entries are the points between layers
LAYERS = ("sage_layer", "gat_layer", "pna_layer_fused", "mpnn_layer_fused")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _cfg(arch, case):
    """The reference's ``gnn_cfg`` on the port's configs."""
    import dataclasses

    from repro_torch import configs

    arch, changes = ref.VARIANTS.get(arch, (arch, {}))
    spec = configs.get_spec(arch)
    kind = "batched_graphs" if case in ref.BATCHED else "full_graph"
    cfg = configs.resolve_gnn_config(spec.reduced, case, {"kind": kind, "d_feat": ref.D_IN})
    return dataclasses.replace(cfg, **changes)


def _tree(a, prefix):
    from repro_torch.models.common import tensors_from_arrays

    return tensors_from_arrays(unflat(a, prefix), torch.device("cpu"))


def _mine(t):
    """This rank's rows of a result (a flat DTensor's local tensor; a plain
    tensor is whole on every rank) as numpy."""
    from repro_torch.dist import sharding as shd

    return shd.local_rows(t).detach().numpy()


@contextlib.contextmanager
def layers_watched(rows, seen, found):
    """Every layer function of :data:`LAYERS` wrapped while inside: at its
    entry, every plain tensor alive whose leading dimension is one of
    ``rows`` is appended to ``found`` (its shape); each layer's output is
    appended to ``seen``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.gnn import layers as L

    saved = {name: getattr(L, name) for name in LAYERS}

    def watch(fn):
        def wrapped(*args, **kwargs):
            gc.collect()
            found.extend(tuple(o.shape) for o in gc.get_objects()
                         if isinstance(o, torch.Tensor) and not isinstance(o, DTensor)
                         and o.dim() > 0 and o.shape[0] in rows)
            out = fn(*args, **kwargs)
            seen.append(out if isinstance(out, tuple) else (out,))
            return out

        return wrapped

    for name, fn in saved.items():
        setattr(L, name, watch(fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(L, name, fn)


def model_cases(a, res, tag, mesh, rank):
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.train import shard_graph, value_and_grad
    from repro_torch.models.gnn import models as gm

    for case, archs in ref.CASES.items():
        for arch in archs:
            key = f"{tag}/{case}/{arch}"
            cfg = _cfg(arch, case)
            params = gm.params_from_arrays(cfg, unflat(a, f"{case}/{arch}/params"), "cpu")
            whole = _tree(a, f"{case}/{arch}/batch")
            n, e = whole["x"].shape[0], whole["src"].shape[0]
            # the rank's own blocks, copied out of the whole batch, which goes
            batch = {k: shd.from_rows(v.to_local().clone(), v.shape[0], v.device_mesh)
                     if shd.is_flat(v) else v for k, v in shard_graph(whole, mesh).items()}
            del whole
            for k, v in batch.items():
                res[f"{key}/batch_local/{k}/{rank}"] = np.asarray(shd.local_rows(v).shape)
            seen, found = [], []
            try:
                with torch.no_grad(), layers_watched((n, e), seen, found):
                    out = gm.forward(params, batch, cfg)
            except ValueError as err:
                res[f"{key}/error"] = np.asarray(str(err))
                continue
            res[f"{key}/out/{rank}"] = _mine(out)
            res[f"{key}/out_flat/{rank}"] = np.asarray(shd.is_flat(out))
            for name, t in zip(("h", "e"), seen[0]):
                res[f"{key}/{name}/{rank}"] = _mine(t)
            res[f"{key}/live_whole/{rank}"] = np.asarray([str(s) for s in found], dtype=str)
            del out, seen
            grad_params = gm.params_from_arrays(cfg, unflat(a, f"{case}/{arch}/params"), "cpu",
                                                trainable=True)
            loss, grads = value_and_grad(lambda p, b: gm.loss_fn(p, b, cfg), grad_params, batch)
            res[f"{key}/loss/{rank}"] = loss.numpy()
            for name, g in grads.items():
                res[f"{key}/grads/{name}/{rank}"] = g.numpy()
            del params, grad_params, grads, batch


def train_cases(a, res, ckpt_root, rank):
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as tr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.gnn import models as gm
    from repro_torch.optim import AdamWConfig

    cfg = _cfg(ref.TRAIN_ARCH, "full")
    params = gm.params_from_arrays(cfg, unflat(a, f"full/{ref.TRAIN_ARCH}/params"), "cpu",
                                   trainable=True)
    batch = _tree(a, f"full/{ref.TRAIN_ARCH}/batch")
    mesh = make_mesh(ref.TRAIN_MESH, ("data", "model"), device="cpu")
    batches, group, on_mesh = tr.data_parallel("gnn", lambda i: batch, mesh)
    res[f"train/placed/{rank}"] = np.asarray(
        [[shd.local_rows(v).numel(), v.numel()] for v in batches(0).values()])
    res[f"train/group_none/{rank}"] = np.asarray(group is None and on_mesh)
    run = tr.Supervised("gnn", params, lambda p, b: gm.loss_fn(p, b, cfg), lambda i: batch,
                        AdamWConfig(lr=ref.TRAIN_LR), warmup=ref.TRAIN_WARMUP,
                        total=ref.TRAIN_STEPS, ckpt_dir=ckpt_root, device="cpu",
                        log=lambda line: None, mesh=mesh)
    run.run(ref.TRAIN_STEPS)
    res[f"train/losses/{rank}"] = np.asarray([x for _, x in run.losses], np.float32)
    state = run.tree()
    for part, tree in (("params", state["params"]), ("m", state["opt"]["m"])):
        from repro_torch.checkpoint.checkpoint import _flatten

        for k, v in _flatten(tree):
            res[f"train/{part}/{k}/{rank}"] = v.detach().numpy()


def _rank(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        from repro_torch.dist import sharding as shd
        from repro_torch.launch.mesh import make_mesh

        a = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        res = {}
        for tag, (shape, axes) in ref.MESHES.items():
            mesh = make_mesh(shape, axes, device="cpu")
            shd.activate(mesh)
            try:
                model_cases(a, res, tag, mesh, rank)
            finally:
                shd.deactivate()
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = [tmp]
            dist.broadcast_object_list(ckpt, src=0)  # one directory for every rank
            train_cases(a, res, ckpt[0], rank)
            dist.barrier()
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, res)
        if rank == 0:
            merged = {}
            for g in gathered:
                merged.update(g)
            np.savez(os.path.join(out_dir, "torch.npz"), **merged)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(_free_port(), sys.argv[1]), nprocs=WORLD)
