"""Training entry point: config → data → step (loss and grads → cosine
schedule → AdamW) → a plain loop.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --reduced --device cpu --steps 5 --batch 2 --seq 32 --log-every 1
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --batch 4 --seq 4096 --steps 8                    # full width, on the card

The JAX package's ``repro.launch.train`` on the port: :func:`build` makes
the same three families' parameters, loss and batches (``token_batches``,
``gnn_full_batch``, ``recsys_batches``, each the JAX package's draws for a
seed), :func:`make_step` is its ``step_fn`` (``value_and_grad`` →
``cosine_schedule`` of the pre-step counter → ``adamw_update``, the
parameters and moments updated in place), and :func:`train` runs it in a
plain loop where JAX runs its ``TrainSupervisor``: the checkpoint, the
restart drill and the straggler monitor (``--ckpt-dir``, ``--ckpt-every``,
``--inject-failures``) wait for the port's checkpoint module (ROADMAP A4).
The parameters are random from ``--seed``, or the JAX package's own
(``build(..., params=...)``). Runs on ``--device cuda`` unless told
otherwise; there the gradients of every kernel on the path are the port's
kernels (``kernels.autograd``).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import configs
from repro_torch.data.pipeline import gnn_full_batch, recsys_batches, token_batches
from repro_torch.graph.structure import resolve_device
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
)


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


def train(arch: str, reduced: bool = False, steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, warmup: int = 20, seed: int = 0,
          device="cuda", log_every: int = 10, params: Optional[Any] = None,
          opt_state: Optional[Dict[str, Any]] = None, log=print) -> List[float]:
    """``steps`` steps of :func:`make_step`'s step from step 0 (AdamW state
    ``opt_state`` or zeros); prints the JAX trainer's ``step … loss …``
    line every ``log_every`` steps and its ``done at step N: loss=…``
    line; returns every step's loss."""
    _, _, p, loss_fn, batch_for_step = build(arch, reduced, batch, seq, seed, device,
                                             params)
    oc = AdamWConfig(lr=lr)
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(args.arch, args.reduced, args.steps, args.batch, args.seq, args.lr,
          args.warmup, args.seed, args.device, args.log_every,
          log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
