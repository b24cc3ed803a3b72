"""Training entry point: config → data → step (loss and grads → cosine
schedule → AdamW) → the supervised loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --reduced --device cpu --steps 20 --batch 2 --seq 32 --log-every 5 \
        --ckpt-dir /tmp/ck --ckpt-every 10 --inject-failures 13
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --batch 4 --seq 4096 --steps 8                    # full width, on the card

The JAX package's ``repro.launch.train`` on the port: :func:`build` makes
the same three families' parameters, loss and batches (``token_batches``,
``gnn_full_batch``, ``recsys_batches``, each the JAX package's draws for a
seed), :func:`make_step` is its ``step_fn`` (``value_and_grad`` →
``cosine_schedule`` of the pre-step counter → ``adamw_update``, the
parameters and moments updated in place), and :class:`Supervised` runs it
under the ``TrainSupervisor`` (``ft.failures``, a copy of JAX's): async
atomic checkpoints in JAX's format every ``--ckpt-every`` steps, resume
from the newest, bounded retry that restores the last checkpoint and
replays, the straggler monitor, SIGTERM saves, and ``--inject-failures``
for drills. :func:`train` is that run (with ``ckpt_dir``) or a plain loop
(without). The parameters are random from ``--seed``, or the JAX
package's own (``build(..., params=...)``). Runs on ``--device cuda``
unless told otherwise; there the gradients of every kernel on the path are
the port's kernels (``kernels.autograd``).

Where JAX's step donates its buffers, the port's step updates the live
tensors in place. So the supervisor sees the state in the JAX nesting
(``{"params", "opt"}``, keyed as JAX's checkpoints) over the live tensors;
its ``init_state`` is a host copy of the initial state, and the step
loads whatever state it is handed — that host copy, or a checkpoint
restored to host memory — into the live tensors before it runs
(``copy_``; nothing when handed the live state itself), so a restore
makes no second copy of the state on the card.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint.checkpoint import _flatten, _unflatten, tree_map
from repro_torch.data.pipeline import gnn_full_batch, recsys_batches, token_batches
from repro_torch.dist import sharding as shd
from repro_torch.ft import FailureInjector, StragglerMonitor, TrainSupervisor
from repro_torch.graph.structure import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import common
from repro_torch.models.gnn import models as gm
from repro_torch.models.recsys import autoint
from repro_torch.models.transformer import model as tm
from repro_torch.optim import (
    AdamWConfig,
    adamw_init,
    adamw_update_,
    cosine_schedule,
    named_leaves,
    opt_state_tree,
)


def make_train_mesh(device="cuda") -> shd.Mesh:
    """2-D ``(data, model)`` mesh over the process group's ranks (model=1:
    the live loop is data-parallel first). One process degrades to a 1×1
    mesh, so every sharding spec still resolves."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return make_mesh((world, 1), ("data", "model"), device=device)


def build(arch: str, reduced: bool, batch: int, seq: int, seed: int, device="cuda",
          params: Optional[Any] = None):
    """``(spec, cfg, params, loss_fn, batch_for_step)`` as the JAX ``build``:
    trainable parameters (random from ``seed``, or the JAX package's tree
    ``params`` of numpy arrays carried across), ``loss_fn(params, batch)``,
    and the batch of each step (16 LM or recsys batches in turn, or one
    full-graph batch)."""
    dev = resolve_device(device)
    spec = configs.get_spec(arch)
    cfg = spec.reduced if reduced else spec.config
    if spec.family == "lm":
        params = (tm.init(cfg, seed, dev, trainable=True) if params is None
                  else tm.params_from_arrays(cfg, params, dev, trainable=True))

        def loss_fn(p, b):
            return tm.loss_fn(p, b, cfg)

        data = token_batches(batch, seq, cfg.vocab_size, seed=seed, device=dev)
        batches = [next(data) for _ in range(16)]

        def batch_for_step(i):
            return batches[i % len(batches)]

    elif spec.family == "gnn":
        params = (common.trainable(gm.init(cfg, seed, dev)) if params is None
                  else gm.params_from_arrays(cfg, params, dev, trainable=True))

        def loss_fn(p, b):
            return gm.loss_fn(p, b, cfg)

        fb = gnn_full_batch(max(batch * 16, 64), 6.0, cfg.d_in, cfg.n_out, seed=seed,
                            task=cfg.task, n_out=cfg.n_out, device=dev)

        def batch_for_step(i):
            return fb

    else:
        params = (common.trainable(autoint.init(cfg, seed, dev)) if params is None
                  else autoint.params_from_arrays(cfg, params, dev, trainable=True))

        def loss_fn(p, b):
            return autoint.loss_fn(p, b, cfg)

        data = recsys_batches(batch, cfg.n_fields, cfg.vocab_per_field, seed=seed,
                              device=dev)
        batches = [next(data) for _ in range(16)]

        def batch_for_step(i):
            return batches[i % len(batches)]

    return spec, cfg, params, loss_fn, batch_for_step


def value_and_grad(loss_fn: Callable, params, batch):
    """``(loss, {leaf name: gradient})``; a leaf the loss does not reach
    gets zeros, as JAX's ``value_and_grad`` gives it."""
    leaves = named_leaves(params)
    with torch.enable_grad():
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(p) if g is None else g
        for (k, p), g in zip(leaves.items(), grads)
    }


def make_step(loss_fn: Callable, oc: AdamWConfig, warmup: int, total: int):
    """The JAX ``step_fn``: ``step(state, batch) -> (state, {"loss"})`` with
    ``state = {"params", "opt"}``, both updated in place."""

    def step(state: Dict[str, Any], batch) -> tuple:
        p, o = state["params"], state["opt"]
        loss, g = value_and_grad(loss_fn, p, batch)
        lr_scale = cosine_schedule(o["step"], warmup=warmup, total=total)
        adamw_update_(p, g, o, oc, lr_scale=lr_scale)
        return state, {"loss": loss}

    return step


def state_tree(params, opt: Dict[str, Any]) -> Dict[str, Any]:
    """The trainer's state in the JAX nesting, ``{"params", "opt"}``, over
    the live tensors (no copy): the tree the supervisor saves and restores,
    keyed as the JAX trainer's checkpoints."""
    tree = tm.params_tree(params) if isinstance(params, tm.TransformerParams) else params
    return {"params": tree, "opt": opt_state_tree(params, tree, opt)}


def host_copy(tree):
    """A copy of every leaf in host memory."""
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def place(tree, shardings):
    """Every leaf of ``tree`` placed by its sharding (``dist.sharding.
    device_put``; on one rank, moved to the mesh's device)."""
    placed = [shd.device_put(t, sh) for (_, t), (_, sh) in zip(_flatten(tree),
                                                                _flatten(shardings))]
    return _unflatten(tree, iter(placed))


class Supervised:
    """The JAX trainer's ``main`` loop: the step of :func:`make_step` over
    ``params`` (and ``opt_state``, else zeros) under a ``TrainSupervisor``
    checkpointing to ``ckpt_dir``. ``total`` is the schedule's length and
    :meth:`run`'s ``n_steps`` where the run stops (a job cut short runs to
    fewer steps than its schedule). ``losses`` collects ``(step index,
    loss)`` of every step run, replays included; ``sup`` is the supervisor
    (its ``retries``, ``restarts`` and ``straggler.events``)."""

    def __init__(self, family: str, params, loss_fn: Callable, batch_for_step: Callable,
                 oc: AdamWConfig, *, warmup: int, total: int, ckpt_dir: str,
                 ckpt_every: int = 50, inject_failures: Sequence[int] = (),
                 opt_state: Optional[Dict[str, Any]] = None, log_every: int = 10,
                 log=print, device="cuda"):
        self.params = params
        self.opt = opt_state or adamw_init(params, oc)
        self.mesh = make_train_mesh(device)
        if self.mesh.size > 1:
            raise NotImplementedError(
                f"training on a {self.mesh.size}-rank mesh: the models on the mesh "
                f"are not ported (ROADMAP A8c)")
        # explicit placement, as JAX's: params by the family's path-keyed
        # rules, the moments like the params, batches over the data group
        live = state_tree(params, self.opt)
        pshard = shd.param_shardings(family, live["params"], self.mesh)
        self.state_shard = {
            "params": pshard,
            "opt": {"m": pshard, "v": pshard,
                    "step": shd.replicated(self.opt["step"], self.mesh)},
        }
        self.batch_shard = shd.batch_shardings(family, batch_for_step(0), self.mesh)
        placed = place(live, self.state_shard)
        if any(a is not b for (_, a), (_, b) in zip(_flatten(live), _flatten(placed))):
            raise ValueError(f"the state is not on the mesh's device {self.mesh.device}")
        self._view = None
        # the step updates the live tensors in place, so the supervisor's
        # restore-and-replay template must be durable: a host copy
        self.init_state = host_copy(live)
        self.losses: List[Tuple[int, float]] = []
        self.log, self.log_every = log, log_every
        self._step = make_step(loss_fn, oc, warmup, total)
        self._last = time.perf_counter()
        self.sup = TrainSupervisor(
            self._wrapped_step,
            lambda i: place(batch_for_step(i), self.batch_shard),
            ckpt_dir=ckpt_dir,
            ckpt_every=ckpt_every,
            injector=FailureInjector(list(inject_failures)) if inject_failures else None,
            straggler=StragglerMonitor(),
            on_straggler=lambda ev: log(f"[straggler] {ev}"),
        )

    def tree(self) -> Dict[str, Any]:
        """The live state in the JAX nesting (what the step hands back)."""
        self._view = state_tree(self.params, self.opt)
        return self._view

    @torch.no_grad()
    def load_(self, state):
        """Copy ``state`` (a host copy or a restored checkpoint, in the JAX
        nesting) into the live tensors; nothing if it is the live state."""
        if state is self._view:
            return
        for (k, dst), (k2, src) in zip(_flatten(self.tree()), _flatten(state)):
            if k != k2:
                raise KeyError(f"state leaf {k2!r} where {k!r} was expected")
            dst.copy_(src)

    def _wrapped_step(self, state, batch):
        self.load_(state)
        _, metrics = self._step({"params": self.params, "opt": self.opt}, batch)
        s = int(self.opt["step"])
        loss = float(metrics["loss"])
        self.losses.append((s - 1, loss))
        if s % self.log_every == 0:
            now = time.perf_counter()
            self.log(f"step {s:5d} loss {loss:.4f} "
                     f"({now - self._last:.2f}s/{self.log_every} steps)")
            self._last = now
        return self.tree(), metrics

    def run(self, n_steps: int):
        """Train to ``n_steps`` (resuming from the newest checkpoint); the
        live tensors then hold the final state. Returns ``(step,
        metrics)``; ``metrics`` is ``None`` when no step ran."""
        shd.activate(self.mesh)
        try:
            state, step, metrics = self.sup.run(self.init_state, n_steps)
        finally:
            shd.deactivate()
        self.load_(state)
        return step, metrics


def train(arch: str, reduced: bool = False, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, warmup: int = 20, seed: int = 0,
          device="cuda", log_every: int = 10, params: Optional[Any] = None,
          opt_state: Optional[Dict[str, Any]] = None, log=print,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          inject_failures: Sequence[int] = ()) -> List[float]:
    """``steps`` steps of :func:`make_step`'s step (AdamW state
    ``opt_state`` or zeros); prints the JAX trainer's ``step … loss …``
    line every ``log_every`` steps and its ``done at step N: loss=…`` line.
    With ``ckpt_dir`` the run is :class:`Supervised` (resumed from the
    newest checkpoint there, ``inject_failures`` the 0-based steps that fail
    once) and the ``done`` line adds the retries, restarts and stragglers;
    without, a plain loop from step 0. Returns the loss of every step run,
    replays included, in order."""
    spec, _, p, loss_fn, batch_for_step = build(arch, reduced, batch, seq, seed, device,
                                                params)
    oc = AdamWConfig(lr=lr)
    if ckpt_dir is not None:
        run = Supervised(spec.family, p, loss_fn, batch_for_step, oc, warmup=warmup,
                         total=steps, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                         inject_failures=inject_failures, opt_state=opt_state,
                         log_every=log_every, log=log, device=device)
        step, metrics = run.run(steps)
        loss = float("nan") if metrics is None else float(metrics["loss"])
        sup = run.sup
        log(f"done at step {step}: loss={loss:.4f} retries={sup.retries} "
            f"restarts={sup.restarts} stragglers={len(sup.straggler.events)}")
        return [x for _, x in run.losses]
    state = {"params": p, "opt": opt_state or adamw_init(p, oc)}
    step_fn = make_step(loss_fn, oc, warmup, steps)
    losses: List[float] = []
    last = time.perf_counter()
    for i in range(steps):
        state, metrics = step_fn(state, batch_for_step(i))
        losses.append(float(metrics["loss"]))
        s = int(state["opt"]["step"])
        if s % log_every == 0:
            now = time.perf_counter()
            log(f"step {s:5d} loss {losses[-1]:.4f} "
                f"({now - last:.2f}s/{log_every} steps)")
            last = now
    log(f"done at step {int(state['opt']['step'])}: loss={losses[-1]:.4f}")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    # the JAX trainer's /tmp/repro_ckpt, under $TMPDIR where it is set
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated step indices to fail at (drill)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(args.arch, args.reduced, args.steps, args.batch, args.seq, args.lr,
          args.warmup, args.seed, args.device, args.log_every,
          log=lambda line: print(line, flush=True), ckpt_dir=args.ckpt_dir,
          ckpt_every=args.ckpt_every,
          inject_failures=[int(x) for x in args.inject_failures.split(",") if x])


if __name__ == "__main__":
    main()
