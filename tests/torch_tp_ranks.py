"""The port's LMs tensor-parallel on a mesh: 4 gloo ranks on the CPU.

    python tests/torch_tp_ranks.py OUT_DIR [ARCH ...]

Helper of ``tests/test_torch_tp.py`` and ``tests/test_torch_tp_moe.py``
(not a test module itself: it imports only ``torch``, numpy and the port,
never ``jax``). It reads ``OUT_DIR/inputs.npz``
(``tests/torch_tp_reference.py``'s ``make_inputs``) and runs, for each
config named (by default the dense ones), on ``("data", "model") = (1, 4)``
and ``(2, 2)`` what the reference runs under JAX's: each rank holds its
shards of the parameters (``launch.train.shard_state_``: the data axes'
FSDP slices, kept in place over ``model``) and its data shard's rows, and
runs under the active mesh — the loss and its gradients, two ``make_step``
steps in ``fsdp`` and in ``zero1``, the same two steps by
``launch.train.Supervised`` on the mesh (its checkpoint under
``OUT_DIR/ckpt/<arch>/<mesh>``), a prefill and three decode steps; for an
MoE config also a forward's dropped slots by layer and the rank's routing
of every layer (expert ids and kept slots, :func:`route_log`), and the
config with experts the model axis does not divide against one rank
(:func:`fallback_case`). Rank 0
writes the results (gradients, parameters and logits gathered whole) to
``OUT_DIR/torch.npz``, with every rank's live shard shapes, logits shape,
cache shard and routing.

A rank that raises makes ``torch.multiprocessing.spawn`` raise, so the
script exits non-zero.
"""

from __future__ import annotations

import contextlib
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))
sys.path.insert(0, str(HERE))

import torch_tp_reference as ref  # noqa: E402  (numpy only at import)
from torch_mesh_ranks import WORLD, _free_port  # noqa: E402
from torch_mesh_reference import unflat  # noqa: E402


def _place(arch, a, mesh, trainable, mode="fsdp", opt=False):
    """The config, the parameters held as this rank's shards under
    ``mode`` (and AdamW moments in ``fsdp``, if ``opt``) and the
    ``Shards``."""
    from repro_torch import configs
    from repro_torch.launch import train as tr
    from repro_torch.models.transformer import model as tm
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = configs.get_spec(arch).reduced
    params = tm.params_from_arrays(cfg, unflat(a, f"{arch}/params"), "cpu",
                                   trainable=trainable)
    moments = adamw_init(params, AdamWConfig(lr=ref.TRAIN_LR)) if opt else None
    shards = tr.shard_state_(params, moments, tr.state_layout("lm", params, mesh, mode),
                             ("data",))
    return cfg, params, moments, shards


def _whole(t, sh):
    from repro_torch.dist import sharding as shd

    return (t if sh is None else shd.unshard(t.detach(), sh)).detach().numpy()


def _paths(params):
    """``named_leaves``' name → the leaf's JAX path (``layers/ffn/w1``)."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.models.transformer import model as tm
    from repro_torch.optim import named_leaves

    name_of = {id(t): k for k, t in named_leaves(params).items()}
    return {name_of[id(t)]: path for path, t in _flatten(tm.params_tree(params))}


@contextlib.contextmanager
def route_log(log):
    """The port's ``moe.dispatch_indices`` wrapped while inside: each call
    appends its ``(expert_idx, keep)`` to ``log``."""
    from repro_torch.models.transformer import moe

    dispatch = moe.dispatch_indices

    def wrapped(expert_idx, n_experts, cap):
        pos, keep = dispatch(expert_idx, n_experts, cap)
        log.append((expert_idx.clone(), keep.clone()))
        return pos, keep

    moe.dispatch_indices = wrapped
    try:
        yield log
    finally:
        moe.dispatch_indices = dispatch


def run_case(a, res, arch, tag, shape, ckpt_root):
    from repro_torch import configs
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as tr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model as tm
    from repro_torch.optim import AdamWConfig, named_leaves

    key = f"{arch}/{tag}"
    rank = dist.get_rank()
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    data, model = shd.axis_group(mesh, ("data",)), shd.axis_group(mesh, ("model",))
    n_data = shape[0]
    i = dist.get_rank(data)
    rows = slice(i * ref.BATCH // n_data, (i + 1) * ref.BATCH // n_data)
    batches = [{k: torch.from_numpy(v)[rows] for k, v in unflat(a, f"{arch}/batch{s}").items()}
               for s in range(ref.TRAIN_STEPS)]

    def on_mesh(fn, *args):
        shd.activate(mesh, batch_split=True)
        try:
            return fn(*args)
        finally:
            shd.deactivate()

    def whole_rows(t, dim_model):  # a rank's rows of a vocab-split result, gathered whole
        return coll.all_gather_dim(coll.all_gather_dim(t, dim_model, model), 0, data).numpy()

    # the loss and its gradients: the step's averaging over the data ranks
    cfg, params, _, shards = _place(arch, a, mesh, trainable=True)
    loss, grads = on_mesh(tr.value_and_grad, lambda p, b: tm.loss_fn(p, b, cfg), params,
                          batches[0])
    res[f"{key}/loss"] = np.asarray(float(coll.psum(loss, data)) / n_data)
    path = _paths(params)
    for k, g in grads.items():
        g = g if k in shards.averaged else coll.psum(g, data) / n_data
        res[f"{key}/grads/{path[k]}"] = _whole(g, shards.params.get(k))
    with torch.no_grad(), route_log([]) as routes:
        logits = on_mesh(lambda: tm.logits_from_hidden(
            params, tm.forward(params, batches[0]["tokens"], cfg)[0], cfg))
    res[f"{key}/logits_shape/{rank}"] = np.asarray(logits.shape)
    if cfg.moe is not None:  # each layer's dropped slots and this rank's routing
        res[f"{key}/drops/{rank}"] = np.asarray([int((~keep).sum()) for _, keep in routes])
        res[f"{key}/routes/{rank}"] = np.concatenate(
            [np.concatenate([idx.numpy().reshape(-1), keep.numpy().astype(np.int32)])
             for idx, keep in routes])

    # two trainer steps in each parameter mode
    oc = AdamWConfig(lr=ref.TRAIN_LR)
    for mode in ref.MODES:
        cfg, params, opt, shards = _place(arch, a, mesh, True, mode, opt=True)
        step = tr.make_step(lambda p, b: tm.loss_fn(p, b, cfg), oc, ref.TRAIN_WARMUP,
                            ref.TRAIN_STEPS, data, shards=shards)
        losses = []
        for b in batches:
            _, metrics = on_mesh(step, {"params": params, "opt": opt}, b)
            losses.append(float(metrics["loss"]))
        res[f"{key}/{mode}/losses"] = np.asarray(losses, np.float32)
        path = _paths(params)
        for k, t in named_leaves(params).items():
            res[f"{key}/{mode}/params/{path[k]}"] = _whole(t, shards.params.get(k))
            res[f"{key}/{mode}/shape/{rank}/params/{path[k]}"] = np.asarray(t.shape)
            for part in ("m", "v"):
                res[f"{key}/{mode}/shape/{rank}/{part}/{path[k]}"] = np.asarray(
                    opt[part][k].shape)

    # the supervised trainer on the same mesh: its checkpoint of the shards
    cfg = configs.get_spec(arch).reduced
    params = tm.params_from_arrays(cfg, unflat(a, f"{arch}/params"), "cpu", trainable=True)
    whole = [{k: torch.from_numpy(v) for k, v in unflat(a, f"{arch}/batch{s}").items()}
             for s in range(ref.TRAIN_STEPS)]
    run = tr.Supervised("lm", params, lambda p, b: tm.loss_fn(p, b, cfg), lambda s: whole[s],
                        oc, warmup=ref.TRAIN_WARMUP, total=ref.TRAIN_STEPS,
                        ckpt_dir=os.path.join(ckpt_root, arch, tag), device="cpu",
                        log=lambda line: None, mesh=mesh)
    run.run(ref.TRAIN_STEPS)
    res[f"{key}/supervised/losses"] = np.asarray([x for _, x in run.losses], np.float32)
    res[f"{key}/supervised/on_mesh"] = np.asarray(run.on_mesh)

    # prefill, then three decode steps on its cache
    cfg, params, _, _ = _place(arch, a, mesh, trainable=False)
    prompt = torch.from_numpy(a[f"{arch}/prompt"])[rows]
    with torch.no_grad():
        logits, cache = on_mesh(tm.prefill, params, prompt, cfg)
        res[f"{key}/prefill/logits"] = whole_rows(logits, 2)
        for part in ("k", "v"):
            res[f"{key}/prefill/{part}/{rank}"] = cache[part].numpy().copy()
        for s in range(ref.DECODE_STEPS):
            tok = torch.from_numpy(a[f"{arch}/decode"][s])[rows]
            res[f"{key}/decode{s}"] = whole_rows(on_mesh(tm.decode_step_, params, cache, tok,
                                                         cfg), 1)
    res[f"{key}/coordinate/{rank}"] = np.asarray(mesh.device_mesh.get_coordinate())


def fallback_case(res, arch):
    """An MoE config whose experts the model axis does not divide (6 on
    (1, 4): JAX's ``_moe_ffn_local``, every rank the whole routed FFN, its
    gradient counted once) against the same config on one rank: the loss
    and every gradient, gathered whole."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as tr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import model as tm
    from repro_torch.models.transformer import moe

    cfg = configs.get_spec(arch).reduced
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=6))
    gen = torch.Generator().manual_seed(11)
    batch = {k: torch.randint(0, cfg.vocab_size, (ref.BATCH, ref.SEQ), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    params = tm.init(cfg, 4, "cpu", trainable=True)
    want_loss, want = tr.value_and_grad(lambda p, b: tm.loss_fn(p, b, cfg), params, batch)
    mesh = make_mesh((1, 4), ("data", "model"), device="cpu")
    shards = tr.shard_state_(params, None, tr.state_layout("lm", params, mesh), ("data",))
    ep, calls = moe.moe_ffn_ep, []
    moe.moe_ffn_ep = lambda *args, **kwargs: calls.append(1) or ep(*args, **kwargs)
    shd.activate(mesh, batch_split=True)
    try:
        loss, got = tr.value_and_grad(lambda p, b: tm.loss_fn(p, b, cfg), params, batch)
    finally:
        shd.deactivate()
        moe.moe_ffn_ep = ep
    res[f"{arch}/fallback/expert_parallel_calls"] = np.asarray(len(calls))
    res[f"{arch}/fallback/loss"] = np.asarray([float(want_loss), float(loss)])
    res[f"{arch}/fallback/grad_rel"] = np.asarray(max(
        float(np.abs(_whole(g, shards.params.get(k)) - want[k].numpy()).max())
        / max(float(want[k].abs().max()), 1e-30) for k, g in got.items()))


def _rank(rank, port, out_dir, archs):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        a = dict(np.load(os.path.join(out_dir, "inputs.npz")))
        res = {}
        for arch in archs:
            for tag, shape in ref.MESHES.items():
                run_case(a, res, arch, tag, shape, os.path.join(out_dir, "ckpt"))
            if arch in ref.MOE_ARCHS:
                fallback_case(res, arch)
        mine = {k: v for k, v in res.items() if k.rsplit("/", 1)[-1] == str(rank)
                or f"/shape/{rank}/" in k}
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, mine)
        if rank == 0:
            for g in gathered:
                res.update(g)
            res["ckpt_root"] = np.asarray(os.path.join(out_dir, "ckpt"))
            np.savez(os.path.join(out_dir, "torch.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(_free_port(), sys.argv[1], tuple(sys.argv[2:]) or ref.ARCHS),
             nprocs=WORLD)
