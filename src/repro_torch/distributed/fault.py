"""Fault-tolerance policies (port of ``repro.distributed.fault``, plain
Python): restart-from-checkpoint, straggler detection.

The runtime contract:
  * every state mutation passes through the CheckpointManager at a step
    cadence; the data pipeline is keyed by step → restarts are exact;
  * ``run_with_restarts`` wraps the training loop: any exception (device
    loss, preemption signal) triggers restore-from-latest and resume, up to
    ``max_restarts``; the loop re-discovers the latest checkpoint;
  * ``StragglerMonitor`` tracks per-step wall times; a step slower than
    ``threshold`` x the rolling median flags a straggler (logged, counted
    and surfaced to the caller so orchestration can act).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

log = logging.getLogger("repro_torch.fault")

__all__ = ["StragglerMonitor", "run_with_restarts", "Preemption"]


class Preemption(Exception):
    """Raised (e.g. by a signal handler) to simulate/flag preemption."""


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 3.0
    window: int = 32

    def __post_init__(self):
        self.times: list[float] = []
        self.stragglers = 0
        self._t0 = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self) -> bool:
        dt = time.monotonic() - self._t0
        hist = self.times[-self.window:]
        is_straggler = False
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            if dt > self.threshold * med:
                self.stragglers += 1
                is_straggler = True
                log.warning("straggler step: %.3fs vs median %.3fs", dt, med)
        self.times.append(dt)
        return is_straggler


def run_with_restarts(make_loop: Callable[[int], int], max_restarts: int = 3):
    """``make_loop(start_step) -> final_step`` runs until done or raises.

    On exception, re-invoke (the loop re-discovers the latest checkpoint).
    Returns (final_step, n_restarts).
    """
    restarts = 0
    while True:
        try:
            final = make_loop(restarts)
            return final, restarts
        except Preemption as e:           # noqa: PERF203
            restarts += 1
            log.warning("restart %d after preemption: %s", restarts, e)
            if restarts > max_restarts:
                raise
        except Exception as e:
            restarts += 1
            log.error("restart %d after failure: %s", restarts, e)
            if restarts > max_restarts:
                raise
