"""The control of each cell, on the card at the cell's own size: the plain
reference computed in the next precision below the one the configuration
states, standing in the program's place, must come out not correct; the
program, on the same seeds and in the same process, must come out
correct. Also a script that prints both sets of readings (the program's
alone with ``--program-only``; with ``--fault``, of the program with one of
`test_bench_faults.PLANTS` planted):

    python benchmark/tests/test_bench_control.py --cell vitl512-train \
        --seeds 1 2 3 --seconds 4
"""

import argparse
import gc
import json
import sys

import pytest

from conftest import ROOT

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def cells():
    from benchlib.manifest import load_manifest
    return sorted(w["name"] for w in load_manifest(ROOT)["workloads"])


def control_seconds(cell_name: str) -> float:
    """The cell's control window (`checks/<cell>.json`)."""
    from benchlib.manifest import find_cell, load_manifest
    return float(find_cell(load_manifest(ROOT), cell_name,
                           ROOT).checks["control_seconds"])


def readings(cell_name: str, seed: int, seconds: float,
             control: bool = True) -> dict:
    """Set up and run the cell's window briefly on the card, then read the
    compared numbers of the program and (with ``control``) of the
    control."""
    import torch
    from benchlib.manifest import find_cell, load_manifest
    from benchlib.runner import Run, full_precision, kind_module
    full_precision()
    cell = find_cell(load_manifest(ROOT), cell_name, ROOT)
    run = Run(cell, seed, seconds, False, "cuda:0", ROOT)
    wl = kind_module(cell).Workload(run)
    wl.setup()
    wl.window(seconds)
    wl.release()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"cell": cell_name, "seed": seed}
    for name, lower in (("program", False), ("control", True))[
            :2 if control else 1]:
        checks = wl.check(control=lower)
        out[name] = {c.name: c.value for c in checks}
        out[name + "_correct"] = all(c.ok for c in checks)
        out[name + "_details"] = run.records.get("check_details", {})
    del wl
    gc.collect()
    torch.cuda.empty_cache()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_fails_where_the_program_passes(card, cell):
    for seed in SEEDS:
        r = readings(cell, seed, control_seconds(cell))
        print(json.dumps(r, default=float))
        assert r["program_correct"], r
        assert not r["control_correct"], r


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--cell", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--program-only", action="store_true")
    p.add_argument("--fault", default=None)
    a = p.parse_args()
    with pytest.MonkeyPatch.context() as mp:
        if a.fault:
            from test_bench_faults import PLANTS
            PLANTS[a.fault](mp)
        for s in a.seeds:
            print(json.dumps(readings(a.cell, s,
                                      a.seconds or control_seconds(a.cell),
                                      not a.program_only),
                             default=float), flush=True)
    sys.exit(0)
