"""Fault tolerance: straggler detection.

``StragglerMonitor`` is a copy of the reference's (pure host code): robust
per-step timing (median + k*MAD) that flags outlier steps — a slow step
throttles the run, so detection must be cheap. The reference module's
heartbeat tracking, elastic re-mesh plan and checkpoint-based recovery wait
for the checkpoint module and the multi-device machinery (ROADMAP Queue A
10 and 13).
"""
from __future__ import annotations

import statistics
import time
from typing import Optional


class StragglerMonitor:
    def __init__(self, window: int = 50, k_mad: float = 5.0,
                 min_steps: int = 10):
        self.window = window
        self.k_mad = k_mad
        self.min_steps = min_steps
        self.times: list[float] = []
        self.flagged: list[tuple[int, float]] = []
        self._t0: Optional[float] = None
        self.step = 0

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self) -> bool:
        """Record one step; True if this step is a straggler outlier."""
        dt = time.monotonic() - self._t0
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        self.step += 1
        hist = self.times[-self.window:]
        is_out = False
        if len(hist) >= self.min_steps:
            med = statistics.median(hist)
            mad = statistics.median([abs(x - med) for x in hist]) or 1e-9
            is_out = dt > med + self.k_mad * mad * 1.4826
        self.times.append(dt)
        if is_out:
            self.flagged.append((self.step, dt))
        return is_out

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
