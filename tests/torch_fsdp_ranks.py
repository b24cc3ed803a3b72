"""The trainer's FSDP-sharded live state on 4 gloo ranks of the CPU.

    python tests/torch_fsdp_ranks.py OUT_DIR

Helper of ``tests/test_torch_fsdp.py`` (not a test module itself: it
imports only ``torch``, numpy and the port, never ``jax``). Every rank runs
``launch.train.Supervised`` over the reduced h2o-danube-1.8b (float32) on
``make_train_mesh``'s ``(4, 1)``, its batch of 4 rows split over the ranks:

* ``state``: each rank's live parameters and moments (their names, shapes
  and bytes) after 4 uninterrupted steps, and the state gathered whole;
  ``OUT_DIR/sharded`` holds that run's checkpoints;
* ``replay``: the same 4 steps as a job stopped after 2 (its checkpoint
  written) and a restart that fails once at step 3 and replays from the
  newest checkpoint: losses and state to compare bit for bit;
* ``resume``: a checkpoint written by the one-rank trainer
  (``OUT_DIR/one``, before the ranks start) restored into the sharded
  trainer: the state it holds, gathered whole;
* ``clip``: the clipping norm of a gradient large enough to clip, its
  leaves cut into this rank's shards, against the whole gradient's norm
  on one rank, and AdamW's update of the shards against the whole
  update's slice;
* ``ep``: the reduced deepseek-moe-16b on ``("data", "model") = (2, 2)``
  with the batch's rows split over ``data`` and the experts over
  ``model`` (the shards' expert stacks gathered over ``data`` only,
  ``moe_ffn_ep`` on each rank's own tokens): the loss against the same
  rows through the whole parameters off the mesh, and the gradients,
  gathered whole, against theirs averaged over the data ranks.

Rank 0 writes ``OUT_DIR/ranks.npz``. A rank that raises makes
``torch.multiprocessing.spawn`` raise, so the script exits non-zero.
"""

from __future__ import annotations

import os
import shutil
import socket
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent / "src"))

WORLD = 4
ARCH, BATCH, SEQ, SEED = "h2o-danube-1.8b", 4, 16, 0
STEPS, STOP, FAIL, LR, WARMUP = 4, 2, 3, 3e-3, 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def trainer(ckpt_dir, inject=(), total=STEPS):
    """A ``Supervised`` over the reduced LM from ``SEED``, checkpointing
    every 2 steps to ``ckpt_dir``."""
    from repro_torch.launch import train as tr
    from repro_torch.optim import AdamWConfig

    _, _, params, loss_fn, batches = tr.build(ARCH, True, BATCH, SEQ, SEED, "cpu")
    return tr.Supervised("lm", params, loss_fn, batches, AdamWConfig(lr=LR), warmup=WARMUP,
                         total=total, ckpt_dir=str(ckpt_dir), ckpt_every=2,
                         inject_failures=inject, device="cpu", log=lambda line: None)


def whole_state(run):
    """``{flat key: numpy array}`` of a trainer's state, its shards gathered
    whole."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.dist import sharding as shd

    out = {}
    for k, t in _flatten(run.tree()):
        sh = run.shardings.get(k)
        out[k] = (t if sh is None else shd.unshard(t, sh)).detach().numpy().copy()
    return out


def state_cases(out_dir, res):
    from repro_torch.checkpoint.checkpoint import _flatten

    run = trainer(Path(out_dir) / "sharded")
    run.run(STEPS)
    for k, t in _flatten(run.tree()):
        res[f"state/shape/{k}"] = np.asarray(t.shape)
    res["state/bytes"] = np.asarray(run.state_bytes())
    res["state/held"] = np.asarray(sorted(run.shards.params))
    res["state/losses"] = np.asarray(run.losses)
    res.update({f"state/whole/{k}": v for k, v in whole_state(run).items()})


def replay_cases(out_dir, res):
    ckpt = Path(out_dir) / "replay"
    stopped = trainer(ckpt)
    stopped.run(STOP)  # a job cut short: its checkpoint at STOP written
    dist.barrier()
    restarted = trainer(ckpt, inject=(FAIL,))
    restarted.run(STEPS)
    res["replay/losses"] = np.asarray(stopped.losses + restarted.losses)
    res["replay/retries"] = np.asarray(restarted.sup.retries)
    res.update({f"replay/whole/{k}": v for k, v in whole_state(restarted).items()})


def resume_cases(out_dir, res):
    ckpt = Path(out_dir) / f"one_copy_{dist.get_rank()}"
    shutil.copytree(Path(out_dir) / "one", ckpt)  # resuming writes nothing, but own it
    run = trainer(ckpt, total=STOP)
    run.run(STOP)  # resumes at the one-rank trainer's step STOP: no step to run
    res["resume/steps_run"] = np.asarray(len(run.losses))
    res.update({f"resume/whole/{k}": v for k, v in whole_state(run).items()})


def clip_cases(res):
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as tr
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update_, global_norm, named_leaves

    _, _, params, _, _ = tr.build(ARCH, True, BATCH, SEQ, SEED, "cpu")
    oc = AdamWConfig(lr=LR)  # clip_norm 1.0
    gen = torch.Generator().manual_seed(1)
    grads = {k: 10.0 * torch.randn(t.shape, generator=gen)
             for k, t in named_leaves(params).items()}
    norm = float(global_norm(grads.values()))
    ref = {k: t.detach().clone() for k, t in named_leaves(params).items()}
    ref_opt = adamw_init(ref, oc)
    adamw_update_(ref, grads, ref_opt, oc)
    mesh = tr.make_train_mesh("cpu")
    opt = adamw_init(params, oc)
    shards = tr.shard_state_(params, opt, tr.state_layout("lm", params, mesh), ("data",))
    mine = {k: (shd.shard_of(g, shards.opt[k]) if k in shards.opt else g)
            for k, g in grads.items()}
    groups = shards.norm_groups()
    res["clip/norm_whole"] = np.asarray(norm)
    res["clip/norm_shards"] = np.asarray(float(global_norm(
        list(mine.values()), [groups.get(k) for k in mine])))
    res["clip/norm_local"] = np.asarray(float(global_norm(mine.values())))
    adamw_update_(params, mine, opt, oc, norm_groups=groups)
    worst = 0.0
    for k, t in named_leaves(params).items():
        want = ref[k] if k not in shards.params else shd.shard_of(ref[k], shards.params[k])
        worst = max(worst, float((t.detach() - want).abs().max()))
    res["clip/update_max_diff"] = np.asarray(worst)


def ep_cases(res):
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as tr
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import moe
    from repro_torch.optim import named_leaves

    _, cfg, params, loss_fn, batches = tr.build("deepseek-moe-16b", True, BATCH, SEQ, SEED,
                                                "cpu")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    data = shd.axis_group(mesh, ("data",))
    i = dist.get_rank(data)
    rows = {k: v[i * BATCH // 2:(i + 1) * BATCH // 2] for k, v in batches(0).items()}
    want_loss, want = tr.value_and_grad(loss_fn, params, rows)
    want = {k: coll.psum(g, data) / 2 for k, g in want.items()}
    shards = tr.shard_state_(params, None, tr.state_layout("lm", params, mesh), ("data",))
    slots = moe.moe_ffn.slots
    shd.activate(mesh, batch_split=True)
    try:
        loss, got = tr.value_and_grad(loss_fn, params, rows)
    finally:
        shd.deactivate()
    res["ep/routed_here"] = np.asarray(moe.moe_ffn.slots - slots)
    res["ep/loss_diff"] = np.asarray(float((loss - want_loss).abs()))
    worst = 0.0
    for k, g in got.items():
        g = g if k in shards.averaged else coll.psum(g, data) / 2
        g = shd.unshard(g, shards.params[k]) if k in shards.params else g
        worst = max(worst, float((g - want[k]).abs().max() / want[k].abs().max()))
    res["ep/grad_rel_diff"] = np.asarray(worst)
    res["ep/expert_shape"] = np.asarray(named_leaves(params)["layers.moe_w1"].shape)


def _rank(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        res = {}
        state_cases(out_dir, res)
        replay_cases(out_dir, res)
        resume_cases(out_dir, res)
        clip_cases(res)
        ep_cases(res)
        mine = {k: v for k, v in res.items() if k.startswith(("state/shape/", "state/bytes"))}
        gathered = [None] * WORLD
        dist.all_gather_object(gathered, mine)
        dist.barrier()
        if rank == 0:
            for r, g in enumerate(gathered):
                res.update({f"rank{r}/{k}": v for k, v in g.items()})
            np.savez(os.path.join(out_dir, "ranks.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(_rank, args=(_free_port(), sys.argv[1]), nprocs=WORLD)
