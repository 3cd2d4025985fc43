"""The traced window: torch.profiler over the whole measured window, reduced
to the device's busy time (the union of its kernels, copies and sets), the
operations that took most device time, and the longest idle gaps named by
what the host was doing in them."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

Interval = Tuple[float, float]


def union_length(intervals: List[Interval]) -> float:
    """Total length covered by possibly overlapping [start, end) pieces."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Interval], lo: float, hi: float
         ) -> List[Interval]:
    """The pieces of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


# the traced window's length at most: the profiler's events of a longer
# window take minutes to collect (a recon scene launches ~50,000 kernels)
TRACE_SECONDS = 10.0


class Tracer:
    """Profiles the first TRACE_SECONDS of the window when ``on`` (the
    traffic kind calls `tick` between requests; the profiler stops at the
    first tick past that time, and the seconds the stop takes, `paused_s`,
    are not the window's); a no-op otherwise."""

    def __init__(self, on: bool, device):
        self.on = on
        self.device = device
        self.prof = None
        self.paused_s = 0.0
        self._stack = None
        self._t0 = None
        self.busy_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.kernel_s: Dict[str, float] = {}

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import time
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._stack = contextlib.ExitStack()
        self.prof = self._stack.enter_context(profile(activities=acts))
        self._stack.enter_context(
            torch.profiler.record_function("bench/window"))
        self._t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stop()
            self._reduce()

    def tick(self) -> None:
        """Between two requests: stop tracing once TRACE_SECONDS have
        passed."""
        import time
        t = time.perf_counter()
        if self._stack is not None and t - self._t0 >= TRACE_SECONDS:
            self._stop()
            self.paused_s += time.perf_counter() - t

    def _stop(self) -> None:
        if self._stack is None:
            return
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        stack, self._stack = self._stack, None
        stack.close()

    def _events(self):
        """(device events, host events, the window): ((start, end) in
        seconds, name) each; the device's are its kernels, copies and sets,
        not the ranges that `record_function` also marks on its stream."""
        dev, host, window = [], [], None
        for ev in self.prof.profiler.kineto_results.events():
            rng = (ev.start_ns() * 1e-9, ev.end_ns() * 1e-9)
            name = ev.name()
            if str(ev.device_type()).endswith("CUDA"):
                if not ev.is_user_annotation():
                    dev.append((rng, name))
            else:
                if name == "bench/window":
                    window = rng
                host.append((rng, name))
        marks = {n for _, n in host if "/" in n}
        return [d for d in dev if d[1] not in marks], host, window

    def _reduce(self) -> None:
        if self.prof is None:
            return
        dev, host, window = self._events()
        if window is None:
            return
        lo, hi = window
        self.window_s = hi - lo
        pieces = [(max(s, lo), min(e, hi)) for (s, e), _ in dev
                  if e > lo and s < hi]
        self.busy_s = union_length(pieces)
        for (s, e), name in dev:
            self.kernel_s[name] = self.kernel_s.get(name, 0.0) + (e - s)
        self.device_ops = sorted(self.kernel_s.items(),
                                 key=lambda kv: -kv[1])[:10]
        longest = sorted(gaps(pieces, lo, hi), key=lambda g: g[0] - g[1])
        self.idle_gaps = [(self._host_at(host, 0.5 * (s + e)), e - s)
                          for s, e in longest[:10]]

    @staticmethod
    def _host_at(host, t: float) -> str:
        """What the host was doing at time ``t``: the innermost named range
        open then (a ``record_function`` span such as ``3dgs/binning`` or
        ``bench/request``) and the innermost operation, or "host"."""
        span, op = None, None
        span_len = op_len = None
        for (s, e), name in host:
            if not (s <= t < e) or name == "bench/window":
                continue
            if "/" in name and (span_len is None or e - s < span_len):
                span, span_len = name, e - s
            if op_len is None or e - s < op_len:
                op, op_len = name, e - s
        parts = [x for x in (span, op) if x is not None]
        if len(parts) == 2 and parts[0] == parts[1]:
            parts = parts[:1]
        return ": ".join(parts) or "host"

    def breakdown(self) -> Optional[dict]:
        if self.busy_s is None:
            return None
        return {"device_ops": [[n, s] for n, s in self.device_ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps]}
