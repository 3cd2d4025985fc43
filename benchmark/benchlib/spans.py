"""The program's spans in a traced window: the ``<layer>/<stage>`` ranges
the port opens while a profiler records (`utils.profiling.span`:
``imaging/load``, ``recon/matching``, ``net/encode``, ``ga/chunk``,
``raster/binning``, ``3dgs/backward``, ...), read from the profiler's
trace once a run and kept in ``run.records``:

  - each span's host seconds and count, summed over its ranges;
  - the CUDA runtime calls made inside spans (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ``cudaMalloc``, ...): count and host seconds by
    the call's name and the spans open around it;
  - the device seconds of the kernels, copies and sets each span
    launched. A kernel belongs to the spans that were open on the host
    when the runtime call that launched it ran, found by the correlation
    id the profiler gives both (``correlation_id()``, the same number on
    the call and on its kernels on the H100; a graph replay's kernels
    carry the id of its ``cudaGraphLaunch``; ``linked_correlation_id()``
    names the operation around the call instead, and 0 for a graph). It
    may run long after, while the host is in another span, and still
    counts to the one that launched it;
  - the window's requests: the benchmark's ``bench/request`` ranges.

A reader divides by the requests and returns None where its spans are not
in the trace: an untraced run, the CPU for device seconds, or a program
that has no such span.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, Optional, Tuple

REQUEST = "bench/request"

# (the runtime call's name, the span names open around it)
CallKey = Tuple[str, FrozenSet[str]]


@dataclass
class Spans:
    host_s: Dict[str, float] = field(default_factory=dict)
    count: Dict[str, int] = field(default_factory=dict)
    # CallKey -> [calls, host seconds]
    calls: Dict[CallKey, list] = field(default_factory=dict)
    # the span names open at the launch -> device seconds of its kernels
    device_s_by_open: Dict[FrozenSet[str], float] = field(
        default_factory=dict)
    device_events: int = 0

    @property
    def requests(self) -> int:
        return self.count.get(REQUEST, 0)

    def device_s(self, name: str) -> Optional[float]:
        """Device seconds of the kernels launched inside ``name``, None
        where no kernel was launched inside it."""
        hits = [s for open_, s in self.device_s_by_open.items()
                if name in open_]
        return sum(hits) if hits else None

    def call_totals(self, call_prefixes: Tuple[str, ...],
                    span_prefixes: Tuple[str, ...]) -> Tuple[int, float]:
        """(calls, host seconds) of the runtime calls whose name starts
        with one of ``call_prefixes``, made while some span whose name
        starts with one of ``span_prefixes`` was open; each call once."""
        n, s = 0, 0.0
        for (call, open_), (k, sec) in self.calls.items():
            if call.startswith(call_prefixes) and any(
                    o.startswith(span_prefixes) for o in open_):
                n, s = n + k, s + sec
        return n, s


def read(events: Iterable) -> Spans:
    """`Spans` of kineto events (``prof.profiler.kineto_results
    .events()``, or objects with the same methods)."""
    out = Spans()
    # (t, 0 a span's end | 1 its start | 2 a runtime call, name, payload)
    bounds = []
    launches: Dict[int, float] = {}   # device correlation id -> seconds
    for ev in events:
        name = ev.name()
        start, end = ev.start_ns() * 1e-9, ev.end_ns() * 1e-9
        if str(ev.device_type()).endswith("CUDA"):
            if not ev.is_user_annotation():
                cid = ev.correlation_id()
                launches[cid] = launches.get(cid, 0.0) + (end - start)
                out.device_events += 1
            continue
        if "/" in name:             # a span, or the benchmark's range
            out.host_s[name] = out.host_s.get(name, 0.0) + (end - start)
            out.count[name] = out.count.get(name, 0) + 1
            bounds.append((end, 0, name, None))
            bounds.append((start, 1, name, None))
        elif name.startswith("cu"):  # cudaLaunchKernel, cuLaunchKernel...
            bounds.append((start, 2, name, (ev.correlation_id(),
                                            end - start)))
    bounds.sort(key=lambda b: (b[0], b[1]))
    open_: Counter = Counter()
    calls: Dict[CallKey, list] = defaultdict(lambda: [0, 0.0])
    dev: Dict[FrozenSet[str], float] = defaultdict(float)
    current: FrozenSet[str] = frozenset()
    for _, order, name, payload in bounds:
        if order == 0:
            open_[name] -= 1
            if not open_[name]:
                del open_[name]
            current = frozenset(open_)
        elif order == 1:
            open_[name] += 1
            current = frozenset(open_)
        else:
            cid, sec = payload
            c = calls[(name, current)]
            c[0] += 1
            c[1] += sec
            if cid in launches:
                dev[current] += launches[cid]
    out.calls = dict(calls)
    out.device_s_by_open = dict(dev)
    return out


def of(run) -> Optional[Spans]:
    """The run's `Spans`, read from its trace on the first call; None
    without a trace."""
    if "spans" not in run.records:
        prof = run.tracer.prof
        run.records["spans"] = (
            None if prof is None
            else read(prof.profiler.kineto_results.events()))
    return run.records["spans"]


def per_request_host_s(run, *names: str) -> Optional[float]:
    """Host seconds a request in the spans ``names`` (which do not nest
    in each other), None where none of them is in the trace."""
    sp = of(run)
    if sp is None or not sp.requests or not any(n in sp.count
                                                for n in names):
        return None
    return sum(sp.host_s.get(n, 0.0) for n in names) / sp.requests


def per_request_device_s(run, name: str) -> Optional[float]:
    """Device seconds a request of the kernels launched in ``name``."""
    sp = of(run)
    if sp is None or not sp.requests:
        return None
    s = sp.device_s(name)
    return None if s is None else s / sp.requests


def network_ms_per_pair(run, name: str) -> Optional[float]:
    """Device ms a pair of the kernels launched in the network stage
    ``name`` (``net/encode``, ``net/decode``, ``net/heads``), over the
    pairs the window's scenes needed (``recon.pairs`` a scene): whatever
    padding the program forwards to fill a batch counts as its cost."""
    sp = of(run)
    pairs = run.records.get("recon.pairs")
    if sp is None or not pairs or not sp.requests:
        return None
    s = sp.device_s(name)
    return None if s is None else 1e3 * s / (pairs * sp.requests)
