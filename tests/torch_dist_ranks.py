"""Gloo ranks on the CPU running the port's mesh, sharding and compressed
data-parallel gradient.

    python tests/torch_dist_ranks.py WORLD OUT_DIR

Helper of ``tests/test_torch_dist.py`` (not a test module itself: it
imports only ``torch`` and the port, never ``jax``).

* With ``WORLD`` 2, first one rank alone (a gloo group of one) saves a
  checkpoint whose leaves are DTensors on one-rank meshes — ``("data",)``
  and ``("data", "model")`` — so the manifest records their specs; then
  two ranks restore it on ``make_mesh((2,), ("data",))``, and each rank's
  local shard must be the slice of the logical array that the spec,
  cleaned for that mesh, names (``np.split`` by hand, not the port's
  slicing): rows split over ``data``, a dimension named by an axis the mesh
  lacks or by one that does not divide it replicated. Both ranks then save
  the restored DTensors again, and the file holds the logical arrays.
* ``WORLD`` ranks run ``make_compressed_dp_grad_fn`` for two steps of
  error feedback on their own shard of one batch; every rank's mean
  gradient and residual must equal (bit for bit) numpy's int32 sum of the
  per-rank int8 values quantized against the shared scale, and the loss
  the mean of the per-rank losses.

A rank that raises makes ``torch.multiprocessing.spawn`` raise, so the
script exits non-zero.
"""

from __future__ import annotations

import socket
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

#: the logical arrays of the checkpoint and the spec each is saved with
#: (mesh axes per dimension), and the dimension 2 ranks split after cleaning
LEAVES = {
    "w": ((8, 6), ("data",), ("data", None), 0),
    "e": ((6, 4), ("data", "model"), ("model", "data"), 1),  # model: not on the new mesh
    "odd": ((5,), ("data",), ("data",), None),  # 5 rows: 2 ranks do not divide them
    "step": ((), None, None, None),  # a plain tensor: no spec
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _init(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)


def _logical(name):
    shape = LEAVES[name][0]
    return np.asarray(np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape) - 7.5)


def _save_one_rank(port, ckpt_dir):
    """One rank: DTensor leaves on one-rank meshes, saved with their specs."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.checkpoint import save_checkpoint

    _init(0, 1, port)
    try:
        tree = {}
        for name, (_, axes, spec, _) in LEAVES.items():
            x = torch.from_numpy(_logical(name))
            if axes is None:
                tree[name] = x
                continue
            mesh = init_device_mesh("cpu", (1,) * len(axes), mesh_dim_names=axes)
            placements = [Shard(spec.index(a)) if a in spec else Replicate() for a in axes]
            tree[name] = DTensor.from_local(x, mesh, placements, run_check=False)
        save_checkpoint(ckpt_dir, 1, tree)
    finally:
        dist.destroy_process_group()


def _restore_two_ranks(rank, ckpt_dir):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2,), ("data",), device="cpu")
    target = {name: torch.zeros(LEAVES[name][0]) for name in LEAVES}
    restored, step, _ = restore_checkpoint(ckpt_dir, target, mesh=mesh)
    assert step == 1
    for name, (_, _, _, split) in LEAVES.items():
        want = _logical(name)
        if split is not None:
            want = np.split(want, 2, axis=split)[rank]
        got = restored[name].to_local().numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"rank {rank} {name}: {got} != {want}")
    # saved again from both ranks: gathered whole, written once (rank 0)
    save_checkpoint(Path(ckpt_dir) / "again", 2, restored)
    dist.barrier()
    again, _, _ = restore_checkpoint(Path(ckpt_dir) / "again", target)
    for name in LEAVES:
        if not np.array_equal(again[name].numpy(), _logical(name)):
            raise AssertionError(f"rank {rank} {name} saved again: {again[name]}")


def _quantized_mean(corrected):
    """The reference: numpy over every rank's error-corrected gradient."""
    scale = np.float32(max(max(float(np.abs(c).max()) for c in corrected), 1e-30)) \
        / np.float32(127.0)
    qs = [np.clip(np.round(c / scale), -127, 127).astype(np.int8) for c in corrected]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0, dtype=np.int32)
    mean = total.astype(np.float32) * scale / np.float32(len(corrected))
    return mean, [c - q.astype(np.float32) * scale for c, q in zip(corrected, qs)]


def _compressed_dp(rank, world):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.grad_compress import make_compressed_dp_grad_fn

    rng = np.random.default_rng(5)  # the same draws on every rank
    w = rng.normal(size=(6, 3)).astype(np.float32)
    batch = rng.normal(size=(4 * world, 6)).astype(np.float32)

    def loss_fn(p, b):
        return ((b @ p["w"]) ** 2).mean()

    def local_grad(r, wv):
        p = torch.from_numpy(wv).requires_grad_(True)
        loss = loss_fn({"w": p}, torch.from_numpy(batch[4 * r:4 * r + 4]))
        (g,) = torch.autograd.grad(loss, p)
        return float(loss.detach()), g.numpy()

    mesh = make_mesh((world,), ("data",), device="cpu")
    fn = make_compressed_dp_grad_fn(loss_fn, mesh)
    params = {"w": torch.from_numpy(w.copy()).requires_grad_(True)}
    res = {"w": torch.zeros(6, 3)}
    want_res = [np.zeros((6, 3), np.float32) for _ in range(world)]
    for it in range(2):
        loss, grads, res = fn(params, torch.from_numpy(batch[4 * rank:4 * rank + 4]), res)
        per_rank = [local_grad(r, w) for r in range(world)]
        want, want_res = _quantized_mean([g + e for (_, g), e in zip(per_rank, want_res)])
        if not np.array_equal(grads["w"].numpy(), want):
            raise AssertionError(f"rank {rank} step {it}: mean {grads['w']} != {want}")
        if not np.array_equal(res["w"].numpy(), want_res[rank]):
            raise AssertionError(f"rank {rank} step {it}: residual differs")
        want_loss = np.mean([x for x, _ in per_rank])
        if not np.isclose(float(loss), want_loss, rtol=1e-6):
            raise AssertionError(f"rank {rank} step {it}: loss {loss} != {want_loss}")
        with torch.no_grad():
            params["w"] -= 0.1 * grads["w"]
        w = params["w"].detach().numpy().copy()


def _rank(rank, world, port, ckpt_dir):
    _init(rank, world, port)
    try:
        if world == 2:
            _restore_two_ranks(rank, ckpt_dir)
        _compressed_dp(rank, world)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    world, out = int(sys.argv[1]), Path(sys.argv[2])
    if world == 2:
        _save_one_rank(_free_port(), out)
    mp.spawn(_rank, args=(world, _free_port(), str(out)), nprocs=world)
