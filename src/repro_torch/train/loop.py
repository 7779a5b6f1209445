"""Fault-tolerant training loop: the reference's Trainer (repro/train/loop.py).

  * auto-resume from the newest complete checkpoint (``CheckpointManager``);
  * preemption: SIGTERM/SIGINT set a flag, and the loop writes an emergency
    checkpoint and stops after the current step;
  * step retry: an exception from the step is recorded and the step re-run
    from the last good state, up to `max_retries` times; then the state is
    checkpointed and the exception re-raised (a kernel fault still ends the
    run);
  * straggler events for steps longer than `step_timeout_s`;
  * NaN guard: a step whose loss is not finite is dropped and counted.

One deviation: `run` restores the SIGTERM/SIGINT handlers it found when it
returns or raises (the reference leaves its own installed).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Iterator

import numpy as np

from repro_torch.checkpoint import CheckpointManager


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    log_every: int = 10
    step_timeout_s: float = 600.0
    max_retries: int = 3
    nan_guard: bool = True


def _host(metrics: dict) -> dict:
    """0-d tensors (or numbers) -> Python floats; waits for the device."""
    return {k: float(v) for k, v in metrics.items()}


class Trainer:
    def __init__(
        self,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        data: Iterator[dict[str, np.ndarray]],
        lcfg: LoopConfig,
    ):
        self.step_fn = step_fn
        self.data = data
        self.lcfg = lcfg
        self.ckpt = CheckpointManager(
            lcfg.checkpoint_dir, lcfg.checkpoint_every, keep_last=3
        )
        self._preempted = False
        self.events: list[dict[str, Any]] = []

    def _install_signals(self) -> dict:
        """Install the preemption handler; returns the handlers it replaced."""
        def handler(signum, frame):
            self._preempted = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # non-main thread
        return previous

    def run(self, state: Any, start_step: int = 0) -> tuple[Any, list[dict]]:
        previous = self._install_signals()
        try:
            return self._run(state, start_step)
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _run(self, state: Any, start_step: int) -> tuple[Any, list[dict]]:
        lcfg = self.lcfg
        history = []
        step = start_step
        while step < lcfg.total_steps:
            batch = next(self.data)
            t0 = time.time()
            retries = 0
            while True:
                try:
                    new_state, metrics = self.step_fn(state, batch)
                    metrics = _host(metrics)
                    break
                except Exception as e:  # transient runtime failure -> retry
                    retries += 1
                    self.events.append(
                        {"step": step, "event": "retry", "error": repr(e)}
                    )
                    if retries > lcfg.max_retries:
                        self.ckpt.maybe_save(step, state, force=True)
                        raise
            dt = time.time() - t0
            if dt > lcfg.step_timeout_s:
                self.events.append(
                    {"step": step, "event": "straggler", "duration_s": dt}
                )

            loss = float(metrics.get("loss", np.nan))
            if self.lcfg.nan_guard and not np.isfinite(loss):
                self.events.append({"step": step, "event": "nan_skip"})
                step += 1
                continue  # drop the poisoned update, keep old state

            state = new_state
            history.append({"step": step, "loss": loss, "time_s": dt, **metrics})
            if step % lcfg.log_every == 0:
                print(f"step {step} loss {loss:.4f} ({dt*1000:.0f} ms)")
            step += 1
            self.ckpt.maybe_save(step, state)
            if self._preempted:
                self.events.append({"step": step, "event": "preempted"})
                self.ckpt.maybe_save(step, state, force=True)
                break
        else:
            self.ckpt.maybe_save(step, state, force=True)
        return state, history
