"""Training statistics collection — a copy of the JAX package's
utils/stats.py (no framework code).

Re-design of the reference's torch_utils/training_stats.py: the host-side
Collector keeps (num, sum, sumsq) windows of the step's scalar metrics and
writes stats.jsonl rows (ref training_loop.py:416-437).
"""
from __future__ import annotations

import json
import time
from typing import Dict, Optional


class Collector:
    """Windowed mean/std aggregation + jsonl sink (ref Collector :115-201)."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self._acc: Dict[str, list] = {}
        self._file = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()

    def report(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            n, s, s2 = self._acc.get(k, (0, 0.0, 0.0))
            v = float(v)
            self._acc[k] = (n + 1, s + v, s2 + v * v)

    def mean(self, name: str) -> float:
        n, s, _ = self._acc.get(name, (0, 0.0, 0.0))
        return s / max(n, 1)

    def std(self, name: str) -> float:
        n, s, s2 = self._acc.get(name, (0, 0.0, 0.0))
        if n == 0:
            return 0.0
        m = s / n
        return max(s2 / n - m * m, 0.0) ** 0.5

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"num": n, "mean": s / max(n, 1),
                "std": self.std(k)}
            for k, (n, s, _) in self._acc.items()
        }

    def flush(self, step: int):
        row = {"step": step, "wall": time.time() - self._t0}
        row.update({k: v["mean"] for k, v in self.as_dict().items()})
        if self._file:
            self._file.write(json.dumps(row) + "\n")
            self._file.flush()
        self._acc.clear()
        return row
