"""Structured metrics logging (jsonl) and wall-clock phase timers (port of
`starst3r_tpu/utils/metrics.py`: `MetricsLogger`, `Timer`, `timed`).

Timers read the host clock: a phase that ends in a host copy of its result
(as every phase of `reconstruct_scene` does) has waited for the device."""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ("MetricsLogger", "Timer", "timed")


class MetricsLogger:
    """Append-only jsonl metrics sink; single-threaded by design."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[Dict[str, Any]] = []
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **kv):
        rec = {"ts": time.time(), "event": event, **kv}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec, default=_jsonable) + "\n")
        return rec


def _jsonable(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


@dataclass
class Timer:
    """Accumulating named wall-clock timers."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def timed(label: str, logger: Optional[MetricsLogger] = None):
    """Log the enclosed block's wall-clock seconds as a "timing" record."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if logger is not None:
        logger.log("timing", label=label, seconds=dt)
