"""A copy of `uninext_tpu/engine/events.py` without the TensorBoard writer
(the port imports nothing of the JAX package).

Metrics storage + writers (terminal, metrics.json).

Parity: detectron2 EventStorage / CommonMetricPrinter / JSONWriter
(detectron2/utils/events.py:50,181,274). Median smoothing over a window for
terminal output, raw scalars appended per-iteration to metrics.json.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


class EventStorage:
    def __init__(self, window_size: int = 20):
        self._window = window_size
        self._history: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=window_size))
        self._latest: Dict[str, float] = {}
        self._latest_iter: Dict[str, int] = {}
        self.iter = 0

    def put_scalars(self, **scalars):
        for k, v in scalars.items():
            v = float(v)
            self._history[k].append(v)
            self._latest[k] = v
            self._latest_iter[k] = self.iter

    def median(self, key: str) -> float:
        vals = sorted(self._history[key])
        return vals[len(vals) // 2] if vals else float("nan")

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)

    def latest_iter(self, key: str) -> int:
        """Iteration at which `key` was last put (for stale-scalar skipping)."""
        return self._latest_iter.get(key, -1)


class JSONWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage):
        rec = {"iteration": storage.iter, **storage.latest()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TerminalWriter:
    def __init__(self, max_iter: Optional[int] = None):
        self.max_iter = max_iter
        self._last_time = time.perf_counter()
        self._last_iter = 0

    def write(self, storage: EventStorage):
        now = time.perf_counter()
        it = storage.iter
        rate = (it - self._last_iter) / max(now - self._last_time, 1e-9)
        self._last_time, self._last_iter = now, it
        losses = "  ".join(f"{k}: {storage.median(k):.4g}"
                           for k in sorted(storage.latest())
                           if k.startswith(("loss", "total")))
        eta = ""
        if self.max_iter and rate > 0:
            secs = (self.max_iter - it) / rate
            eta = f"eta: {int(secs // 3600)}:{int(secs % 3600 // 60):02d}  "
        print(f"iter: {it}  {eta}{losses}  it/s: {rate:.2f}", flush=True)
