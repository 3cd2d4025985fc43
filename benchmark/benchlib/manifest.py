"""BENCHMARK.json and the files it names: each configuration, traffic mix
and per-layer metric is found by its name, and each cell's limits of
`correct` by the cell's name (`checks/<cell>.json`), so a new cell or
metric is a new file and a new entry, never an edit."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]     # the end-to-end metrics this cell reports
    per_layer: List[dict]      # the per-layer metrics this cell reports
    checks: dict               # checks/<cell>.json: limits, control window


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    wl = metric.get("workloads")
    return wl is None or cell in wl


def traffic_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "traffic" / f"{name}.json"


def checks_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "checks" / f"{name}.json"


def metric_path(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "metrics" / f"{name}.py"


def find_cell(manifest: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration file, its traffic file, its
    checks file and the metrics it reports. Raises KeyError for an unknown
    cell."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg_entry = configs[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"], root / "benchmark")) as f:
        traffic = json.load(f)
    with open(checks_path(name, root / "benchmark")) as f:
        checks = json.load(f)
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if m["moves"] in reported and _reports(m, name)]
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                traffic, e2e, per_layer, checks)


def load_metric(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The reader module of per-layer metric ``name``
    (`benchmark/metrics/<name>.py`, which defines ``read(run)``)."""
    path = metric_path(name, bench_dir)
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(cell: Cell, run, bench_dir: Path = BENCH_DIR
                 ) -> Dict[str, Optional[float]]:
    """{metric name: value, or None where its reader found nothing}."""
    return {m["name"]: load_metric(m["name"], bench_dir).read(run)
            for m in cell.per_layer}
