"""Fault tolerance: straggler watchdog and the checkpoint-restart loop.

The policy layer of the reference's ``train/fault_tolerance.py``, testable on
one host:

  * ``StepWatchdog``  — per-step wall-time tracking; flags stragglers when a
    step exceeds ``threshold x`` the trailing median.
  * ``ResilientLoop`` — run steps, checkpoint every N, on failure restore
    the latest complete checkpoint and continue (with an injectable failure
    hook used by the tests).  Under a mesh every rank runs the loop: a
    failure that every rank raises at the same step restores the latest
    checkpoint on every rank, each into its own shards.
  * ``elastic_restore`` — restore onto a different (survivor) mesh.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable

import torch

from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class StepWatchdog:
    threshold: float = 3.0          # x median => straggler
    window: int = 32
    _times: list = dataclasses.field(default_factory=list)
    stragglers: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; True if this step is a straggler."""
        history = self._times[-self.window:]
        is_straggler = False
        if len(history) >= 8:
            med = statistics.median(history)
            if seconds > self.threshold * med:
                is_straggler = True
                self.stragglers.append((step, seconds, med))
        self._times.append(seconds)
        return is_straggler

    @property
    def median(self) -> float:
        h = self._times[-self.window:]
        return statistics.median(h) if h else 0.0


class InjectedFailure(RuntimeError):
    """Stand-in for a collective timeout / lost host."""


@dataclasses.dataclass
class ResilientLoop:
    """Checkpoint-restart training loop.  ``step_fn`` updates the
    model and the optimizer state in place and returns them; a restore
    writes the checkpoint's values back into the same tensors."""

    step_fn: Callable[..., tuple]        # (params, opt, batch) -> (p, o, m)
    batch_fn: Callable[[int], Any]       # step -> batch
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restores: int = 8
    failure_hook: Callable[[int], None] | None = None  # tests inject faults
    watchdog: StepWatchdog = dataclasses.field(default_factory=StepWatchdog)

    def run(self, params, opt_state, start_step: int, num_steps: int,
            log_every: int = 0, log_fn=print):
        step = start_step
        restores = 0
        metrics = None
        while step < start_step + num_steps:
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                t0 = time.monotonic()
                batch = self.batch_fn(step)
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                loss = metrics.get("loss")
                if isinstance(loss, torch.Tensor) and loss.is_cuda:
                    torch.cuda.synchronize(loss.device)  # the step's end
                self.watchdog.observe(step, time.monotonic() - t0)
                step += 1
                if step % self.ckpt_every == 0:
                    ckpt.save(self.ckpt_dir, step, params, opt_state)
                    ckpt.gc_old(self.ckpt_dir, self.keep)
                if log_every and step % log_every == 0:
                    log_fn(f"step {step}: " + ", ".join(
                        f"{k}={float(v):.4f}" for k, v in metrics.items()))
            except InjectedFailure:
                restores += 1
                if restores > self.max_restores:
                    raise
                last = ckpt.latest_step(self.ckpt_dir)
                if last is None:  # nothing saved yet — restart from given state
                    step = start_step
                    continue
                restored, _ = ckpt.restore(
                    self.ckpt_dir, last, {"params": params,
                                          "opt_state": opt_state})
                params, opt_state = restored["params"], restored["opt_state"]
                step = last
        return params, opt_state, {"final_step": step, "restores": restores,
                                   "metrics": metrics}


def elastic_restore(ckpt_dir: str, step: int, template, target_shardings):
    """Restore a checkpoint onto a different (survivor) mesh topology:
    ``target_shardings`` is ``train/sharded.py``'s ``layout`` on it."""
    return ckpt.restore(ckpt_dir, step, template, shardings=target_shardings)
