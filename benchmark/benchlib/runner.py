"""One run of one cell: set up, warm up, measure, read, check, report."""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import device as devmod
from .manifest import ROOT, Cell, find_cell, load_manifest, read_metrics
from .trace import Tracer

# top-level module names no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "starst3r_tpu")


@dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct only if every value is finite and at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclass
class Run:
    """What a run knows, shared by the traffic kind and the metric
    readers: the cell, its seed, the device, the window's length, the
    program's counters and spans as the kind recorded them, and, in a
    traced run, the trace."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    root: Path = ROOT
    tracer: Optional[Tracer] = None
    timer: devmod.KernelTimer = field(default_factory=devmod.KernelTimer)
    window_s: float = 0.0
    records: Dict[str, object] = field(default_factory=dict)

    def __post_init__(self):
        if self.tracer is None:
            self.tracer = Tracer(False, self.device)

    def rng(self, purpose: str) -> np.random.Generator:
        """A generator for one purpose, a function of the seed alone."""
        tag = int.from_bytes(purpose.encode()[:8].ljust(8, b"\0"), "little")
        return np.random.default_rng([self.seed, tag])

    def torch_seed(self, purpose: str) -> int:
        return int(self.rng(purpose).integers(0, 2 ** 63 - 1))

    @contextlib.contextmanager
    def phase(self, name: str):
        """Host seconds of one part of the set-up, for the record."""
        t = time.perf_counter()
        try:
            yield
        finally:
            phases = self.records.setdefault("setup_phases", {})
            phases[name] = phases.get(name, 0.0) + time.perf_counter() - t


def worst(*values: float) -> float:
    """The largest of ``values``, and NaN if any is NaN (`max` would drop
    a NaN that is not first)."""
    vals = [float(v) for v in values]
    return float("nan") if any(v != v for v in vals) else max(vals)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def set_environment(root: Path) -> None:
    """Fixed cache directories inside the checkout, and nothing that would
    make a library load JAX."""
    cache = root / ".bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("STARST3R_TRACE_DIR", None)


def full_precision() -> None:
    """float32 as the configurations state it: no TF32 in matmuls or
    convolutions (the network's bfloat16 runs under its own autocast)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def kind_module(cell: Cell):
    return importlib.import_module(f"benchlib.kinds.{cell.traffic['kind']}")


def run_cell(run: Run, t_start: float) -> dict:
    """Set up, measure and check ``run``'s cell; returns the result."""
    import torch

    full_precision()
    wl = kind_module(run.cell).Workload(run)
    wl.setup()
    devmod.synchronize(run.device)
    setup_s = time.perf_counter() - t_start

    run.tracer = Tracer(run.trace, run.device)
    with run.tracer.window():
        t = time.perf_counter()
        wl.window(run.seconds)
        devmod.synchronize(run.device)
        run.window_s = time.perf_counter() - t - run.tracer.paused_s
    device = devmod.device_info(run.device, run.cell.chips)

    metrics: Dict[str, dict] = {}
    if run.trace:
        values = read_metrics(run.cell, run)
        units = {m["name"]: m["unit"] for m in run.cell.per_layer}
        for name, v in values.items():
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}
        if run.tracer.busy_s is not None:
            device["busy_s"] = run.tracer.busy_s
            device["window_s"] = run.tracer.window_s
    else:
        e2e = dict(wl.end_to_end())
        e2e["setup_s"] = setup_s
        for m in run.cell.end_to_end:
            metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                  "unit": m["unit"]}

    attempted, failed = wl.attempted, wl.failed
    wl.release()
    gc.collect()
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    checks: List[Check] = wl.check()
    correct = bool(checks) and all(c.ok for c in checks) and failed == 0
    result = {"correct": correct, "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": device}
    if run.trace:
        bd = run.tracer.breakdown()
        if bd is not None:
            result["breakdown"] = bd
    result["checks"] = {c.name: {"value": float(c.value),
                                 "limit": float(c.limit)} for c in checks}
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    root = ROOT
    cell = find_cell(load_manifest(root), args.workload, root)
    set_environment(root)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
              root)
    result = run_cell(run, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"card: {devmod.card_limit()}", file=sys.stderr)
    print(f"setup phases: {run.records.get('setup_phases', {})}",
          file=sys.stderr)
    for name, v in run.records.get("check_details", {}).items():
        print(f"detail {name}: {v}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
