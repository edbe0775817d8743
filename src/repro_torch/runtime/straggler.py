"""Straggler detection and mitigation.

Per-step wall times feed a rolling window; a step (or worker) is a straggler
when its time exceeds median + k*MAD. Mitigations (policy hooks):
  'flag'     -> report only
  'deadline' -> return a step deadline = median * slack for bounded-latency
                collectives (the caller skips/retries past it)
  'rebalance'-> suggest shrinking the microbatch count of the slow worker
At real scale the signals come per-host from the coordinator; here workers
are simulated (tests/test_straggler.py).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class StragglerMonitor:
    window: int = 32
    k_mad: float = 5.0
    deadline_slack: float = 2.0
    times: Dict[str, Deque[float]] = field(default_factory=dict)

    def record(self, worker: str, seconds: float) -> None:
        self.times.setdefault(worker, deque(maxlen=self.window)).append(seconds)

    def _stats(self) -> Tuple[float, float]:
        allt = np.concatenate([np.asarray(d) for d in self.times.values()]) \
            if self.times else np.array([0.0])
        med = float(np.median(allt))
        mad = float(np.median(np.abs(allt - med))) + 1e-12
        return med, mad

    def stragglers(self) -> List[str]:
        med, mad = self._stats()
        out = []
        for w, d in self.times.items():
            recent = float(np.median(np.asarray(d)[-4:]))
            if recent > med + self.k_mad * mad:
                out.append(w)
        return out

    def deadline(self) -> float:
        med, _ = self._stats()
        return med * self.deadline_slack

    def rebalance_hint(self) -> Dict[str, float]:
        """worker -> suggested relative microbatch share (1.0 = unchanged)."""
        med, _ = self._stats()
        hints = {}
        for w, d in self.times.items():
            recent = float(np.median(np.asarray(d)[-4:]))
            if recent > 0:
                hints[w] = float(np.clip(med / recent, 0.25, 1.0))
        return hints
