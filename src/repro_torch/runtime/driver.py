"""Fault-tolerant training driver (the port's copy of
``repro/runtime/driver.py``): checkpoint/restart and a straggler watch.

The driver runs N steps, checkpointing every K; on any step exception or
a non-finite loss it restores the newest valid checkpoint (the data
pipeline's step comes back from the checkpoint's ``extra``) and goes on,
up to ``max_restarts``; a per-step wall-clock EWMA flags stragglers, and
a run of them checkpoints and rebuilds the step with
``on_failure_rebuild``. Parameters are an ``nn.Module`` updated in place
by the step; the checkpoint tree is ``{"params": model.state_dict(),
"opt": opt_state}``, restored into the live tensors in place.

The reference's ``ExecutionPlan``-first construction (mesh, shardings,
re-planning after a failure) needs the planner: ROADMAP A13.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.data.pipeline import TokenPipeline


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA + threshold outlier detection on step wall-clock."""

    alpha: float = 0.1
    threshold: float = 2.5
    warmup: int = 5
    _mean: float = 0.0
    _count: int = 0
    events: int = 0

    def observe(self, dt: float) -> bool:
        self._count += 1
        if self._count <= self.warmup:
            self._mean = dt if self._mean == 0 else (self._mean + dt) / 2
            return False
        slow = dt > self.threshold * self._mean
        if slow:
            self.events += 1
        self._mean = (1 - self.alpha) * self._mean + self.alpha * dt
        return slow


@dataclasses.dataclass
class DriverConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    keep: int = 3
    max_restarts: int = 3
    straggler_restart_after: int = 10  # consecutive straggler events


class TrainDriver:
    """Wraps (step_fn, model, opt_state, pipeline) with checkpoint/restart
    semantics: ``step_fn(model, opt_state, batch) -> (model, opt_state,
    metrics)`` with ``metrics["loss"]``."""

    def __init__(self, step_fn: Callable, params=None, opt_state=None,
                 pipeline: Optional[TokenPipeline] = None,
                 ckpt: Optional[Checkpointer] = None,
                 cfg: DriverConfig = DriverConfig(),
                 on_failure_rebuild: Optional[Callable[[], Callable]] = None):
        if not callable(step_fn):
            raise NotImplementedError(
                "TrainDriver(plan, ...): the ExecutionPlan-first "
                "construction needs the planner, not ported yet (ROADMAP "
                "A13); pass (step_fn, model, opt_state, pipeline, ckpt)")
        if params is None or opt_state is None or pipeline is None \
                or ckpt is None:
            raise TypeError("TrainDriver needs (step_fn, params, opt_state, "
                            "pipeline, ckpt)")
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.ckpt = ckpt
        self.cfg = cfg
        self.monitor = StragglerMonitor()
        self.on_failure_rebuild = on_failure_rebuild
        self.restarts = 0
        self.metrics_log: list = []

    def _tree(self) -> dict:
        return {"params": self.params.state_dict(), "opt": self.opt_state}

    def _restore(self) -> int:
        restored, extra, step = self.ckpt.restore(self._tree())
        if restored is None:
            return 0
        self.pipeline.state.step = int((extra or {}).get("data_step", step))
        return int((extra or {}).get("train_step", step))

    def _save(self, step: int, block: bool = False) -> None:
        self.ckpt.save(step, self._tree(),
                       extra={"train_step": step,
                              "data_step": self.pipeline.state.step},
                       block=block)

    def run(self, start_step: Optional[int] = None) -> Dict[str, Any]:
        step = self._restore() if start_step is None else start_step
        consecutive_stragglers = 0
        while step < self.cfg.total_steps:
            batch = self.pipeline.next_batch()
            t0 = time.time()
            try:
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}")
            except Exception as e:  # device loss / preemption / blowup
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(f"exceeded max_restarts: {e}") from e
                if self.on_failure_rebuild is not None:
                    self.step_fn = self.on_failure_rebuild()
                step = self._restore()
                continue
            dt = time.time() - t0
            if self.monitor.observe(dt):
                consecutive_stragglers += 1
                if (consecutive_stragglers >= self.cfg.straggler_restart_after
                        and self.on_failure_rebuild is not None):
                    # persistent straggler: checkpoint + rebuild the step
                    self._save(step, block=True)
                    self.step_fn = self.on_failure_rebuild()
                    consecutive_stragglers = 0
            else:
                consecutive_stragglers = 0
            self.metrics_log.append({"step": step, "loss": loss,
                                     "time_s": dt})
            step += 1
            if step % self.cfg.checkpoint_every == 0:
                self._save(step)
        self._save(self.cfg.total_steps, block=True)
        self.ckpt.wait()
        return {"final_step": self.cfg.total_steps, "restarts": self.restarts,
                "straggler_events": self.monitor.events,
                "log": self.metrics_log}
