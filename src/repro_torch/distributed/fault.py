"""Fault tolerance: restart manager and straggler watchdog, the port's
counterparts of the JAX package's `distributed/fault.py`.

- `RestartManager` drives the train loop: it restores the newest
  checkpoint (params + optimizer + data-pipeline step) on entry, saves
  every `save_every` steps, and `run()` retries the loop across worker
  crashes with bounded restarts.
- `StragglerWatchdog` tracks a step-time EWMA; a step slower than
  `threshold x` the EWMA is flagged, counted and handed to an injectable
  policy hook.

`elastic_shardings` (re-placement onto another mesh) comes with
data-parallel training over a mesh (ROADMAP Queue 1); restores come back
on the template's devices.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections.abc import Callable
from typing import Any

from .. import checkpoint as ckpt

log = logging.getLogger("repro_torch.fault")


class StragglerWatchdog:
    def __init__(self, threshold: float = 2.0, alpha: float = 0.1,
                 on_straggler: Callable[[int, float, float], None] | None
                 = None):
        self.threshold = threshold
        self.alpha = alpha
        self.ewma: float | None = None
        self.flagged: list[tuple[int, float]] = []
        self.on_straggler = on_straggler
        self._t0: float | None = None

    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        if self.ewma is not None and dt > self.threshold * self.ewma:
            self.flagged.append((step, dt))
            log.warning("straggler: step %d took %.3fs (EWMA %.3fs)",
                        step, dt, self.ewma)
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
        self.ewma = dt if self.ewma is None else (
            (1 - self.alpha) * self.ewma + self.alpha * dt)
        return dt


@dataclasses.dataclass
class RestartManager:
    """`device` is where a protected checkpoint is encoded and corrected
    (the card unless the caller asks for the CPU)."""

    directory: str
    save_every: int = 50
    max_restarts: int = 3
    protect: bool = False
    device: Any = None

    def restore_or_init(self, init_fn: Callable[[], Any], template=None):
        """Returns (state, start_step, data_state). `state` comes from the
        newest checkpoint if one exists, else `init_fn()`."""
        step = ckpt.latest_step(self.directory)
        if step is None:
            return init_fn(), 0, None
        template = template if template is not None else init_fn()
        state, manifest = ckpt.restore_checkpoint(
            self.directory, template, step=step, device=self.device)
        log.info("restored checkpoint step=%d from %s", step, self.directory)
        return state, step, manifest["extra"].get("data_state")

    def maybe_save(self, step: int, state, data_state: dict | None = None):
        if step > 0 and step % self.save_every == 0:
            ckpt.save_checkpoint(self.directory, step, state,
                                 extra={"data_state": data_state},
                                 protect=self.protect, device=self.device)

    def run(self, make_loop: Callable[[int, dict | None], int],
            init_fn: Callable[[], Any]):
        """Crash-resilient driver: `make_loop(start_step, data_state)` runs
        until done (returns the final step) or raises; on an exception the
        newest checkpoint is restored and the loop re-entered, up to
        `max_restarts` times."""
        restarts = 0
        while True:
            _state, start, data_state = self.restore_or_init(init_fn)
            try:
                return make_loop(start, data_state)
            except Exception as e:                     # noqa: BLE001
                restarts += 1
                log.error("worker failed at restart %d: %s", restarts, e)
                if restarts > self.max_restarts:
                    raise
