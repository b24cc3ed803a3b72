"""Fault-tolerance harness: retry, stragglers, preemption, failure injection.

At thousands of nodes, *something* is always failing. The supervisor wraps
the train step with:

* **checkpoint/restart** — resume from the newest complete checkpoint on
  (re)start; periodic async saves; save-on-preemption (SIGTERM);
* **bounded retry** — a failed step restores the last checkpoint and
  replays (covers transient ICI/host faults); repeated failures escalate;
* **straggler detection** — per-step wall-time EMA; steps slower than
  ``straggler_factor ×`` EMA fire a callback (at deployment: trigger
  hot-spare swap / re-slice; here: recorded + surfaced in metrics);
* **failure injection** — deterministic fault schedules for tests/drills.

The data-loader contract is a step-indexed iterator factory, so replays are
deterministic (same batch for a replayed step).
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint


class InjectedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raise at the given (0-based) step indices — once each."""

    fail_at: List[int] = field(default_factory=list)
    _fired: set = field(default_factory=set)

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected fault at step {step}")


@dataclass
class StragglerMonitor:
    """EMA-based slow-step detector."""

    factor: float = 3.0
    alpha: float = 0.1
    warmup: int = 3
    ema: Optional[float] = None
    events: List[Dict] = field(default_factory=list)
    _seen: int = 0

    def observe(self, step: int, dt: float) -> bool:
        self._seen += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = (
            self._seen > self.warmup and dt > self.factor * self.ema
        )
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        else:
            # stragglers don't poison the EMA
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


class TrainSupervisor:
    """Run a train loop with checkpoint/restart + retry + stragglers.

    ``step_fn(state, batch) -> (state, metrics)`` must be pure;
    ``state`` is any pytree (params/opt/step counter).
    """

    def __init__(
        self,
        step_fn: Callable,
        batch_for_step: Callable[[int], object],
        ckpt_dir: str,
        ckpt_every: int = 50,
        max_retries: int = 3,
        injector: Optional[FailureInjector] = None,
        straggler: Optional[StragglerMonitor] = None,
        on_straggler: Optional[Callable[[Dict], None]] = None,
    ):
        self.step_fn = step_fn
        self.batch_for_step = batch_for_step
        self.ckpt = AsyncCheckpointer(ckpt_dir)
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.injector = injector
        self.straggler = straggler or StragglerMonitor()
        self.on_straggler = on_straggler
        self.retries = 0
        self.restarts = 0
        self._preempted = False

    def _install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on main thread (tests)

    def run(self, init_state, n_steps: int, mesh=None, sharding_fn=None):
        """Train to ``n_steps``; resumes from the newest checkpoint if any."""
        self._install_preemption_handler()
        state = init_state
        start = 0
        if latest_step(self.ckpt_dir) is not None:
            state, start, _ = restore_checkpoint(
                self.ckpt_dir, init_state, mesh=mesh, sharding_fn=sharding_fn
            )
            self.restarts += 1
        step = start
        metrics = None
        while step < n_steps:
            if self._preempted:
                self.ckpt.wait()
                self.ckpt.save(step, state, {"preempted": True})
                self.ckpt.wait()
                raise SystemExit(143)
            batch = self.batch_for_step(step)
            t0 = time.perf_counter()
            try:
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                state, metrics = self.step_fn(state, batch)
            except SystemExit:
                raise
            except Exception:
                self.retries += 1
                if self.retries > self.max_retries:
                    raise
                # restore-and-replay from last durable state; an in-flight
                # async save is durable too — join it before scanning, or a
                # failure right after ckpt.save() replays from much older
                # state than necessary
                self.ckpt.wait()
                ls = latest_step(self.ckpt_dir)
                if ls is not None:
                    state, step, _ = restore_checkpoint(
                        self.ckpt_dir, init_state, mesh=mesh,
                        sharding_fn=sharding_fn,
                    )
                else:
                    state, step = init_state, 0
                continue
            dt = time.perf_counter() - t0
            if self.straggler.observe(step, dt) and self.on_straggler:
                self.on_straggler(self.straggler.events[-1])
            step += 1
            if step % self.ckpt_every == 0 or step == n_steps:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        return state, step, metrics
