"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest
from conftest import BENCH, ROOT  # noqa: F401

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|"
                   r"head_size|expansion|experts_per_token|embed")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_text(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and \
                        not (group == "per_layer" and key == "source"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                        and "\t" not in e[key], (e["name"], key)
    for group in ("configs", "workloads"):
        seen = [e["name"] for e in bench[group]]
        assert len(seen) == len(set(seen))
    metrics = [e["name"] for e in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"]), c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_it_must(bench):
    from benchlib.manifest import find_cell
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell = find_cell(bench, w["name"], ROOT)
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2, w["name"]
        assert cell.per_layer, w["name"]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_files_found_by_name(bench):
    from benchlib.manifest import load_metric, metric_path, traffic_path
    import importlib
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        with open(traffic_path(w["traffic"], BENCH)) as f:
            kind = json.load(f)["kind"]
        importlib.import_module(f"benchlib.kinds.{kind}")
    for m in bench["per_layer"]:
        assert metric_path(m["name"], BENCH).exists()
        assert callable(load_metric(m["name"], BENCH).read)


def test_every_cell_has_its_limits(bench):
    """Each cell's limits of `correct` and its control window sit in
    `checks/<cell>.json`, found by the cell's name, one file a cell."""
    from benchlib.manifest import checks_path, find_cell
    names = {w["name"] for w in bench["workloads"]}
    assert {p.stem for p in (BENCH / "checks").glob("*.json")} == names
    for name in names:
        assert checks_path(name, BENCH).exists()
        checks = find_cell(bench, name, ROOT).checks
        assert checks["limits"] and checks["control_seconds"] > 0
        assert all(v >= 0 for v in checks["limits"].values()), name


def test_check_budget_fits(bench):
    """A full check of 24 cells fits in 43200 seconds."""
    rs = bench["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_traffic_and_metric_files_are_named_as_names():
    for p in list((BENCH / "traffic").iterdir()) + \
            list((BENCH / "metrics").glob("*.py")) + \
            list((BENCH / "checks").glob("*.json")):
        assert NAME.match(p.name.rsplit(".", 1)[0]), p.name
