"""Whole runs of tiny cells on the CPU, the references against the program
at tiny sizes, and the harness's refusals."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_tiny
from conftest import BENCH, ROOT


@pytest.mark.parametrize("kind", ["recon", "train", "render"])
def test_tiny_cell_is_correct(kind):
    result = bench_tiny.run_tiny(kind, seconds=0.5)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"
    e2e = bench_tiny.E2E[kind]
    assert result["metrics"][e2e]["value"] > 0
    assert result["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("cell", ["vitl224-recon", "vitl512-train",
                                  "vitl512-render"])
def test_traced_tiny_cell_reads_its_metrics(cell):
    """Every reader of the cell runs; on the CPU the device's readers find
    nothing and leave their metric out."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    per_layer = [m for m in bench["per_layer"] if cell in m["workloads"]]
    kind = cell.split("-")[1]
    result = bench_tiny.run_tiny(kind, seconds=0.5, trace=True,
                                 per_layer=per_layer)
    assert result["correct"]
    for name, m in result["metrics"].items():
        assert np.isfinite(m["value"]), name
    assert result["device"]["busy_s"] == 0.0      # no device on the CPU


def test_reference_rasterizer_matches_the_program():
    from reference.raster import render_one
    from starst3r_tpu_torch.splat.rasterize import rasterize
    g = torch.Generator().manual_seed(0)
    n = 300
    means = torch.randn(n, 3, generator=g) * 0.8 + torch.tensor([0, 0, 4.0])
    quats = torch.randn(n, 4, generator=g)
    scales = torch.rand(n, 3, generator=g) * 0.08 + 0.01
    opac = torch.rand(n, generator=g) * 0.9 + 0.05
    sh = torch.randn(n, 4, 3, generator=g) * 0.3
    w2c = torch.eye(4)
    K = torch.tensor([[40.0, 0, 24], [0, 40.0, 16], [0, 0, 1]])
    rgb, alpha, _ = rasterize(means, quats, scales, opac, sh, w2c[None],
                              K[None], 48, 32, sh_degree=1, tile_size=16,
                              max_tiles_per_gaussian=8, max_per_tile=64)
    ref, ref_a, _ = render_one({"means": means, "quats": quats,
                                "scales": scales, "opacities": opac,
                                "sh": sh}, w2c, K, 48, 32, 16, 8, 64)
    assert float((rgb[0] - ref).abs().max()) < 1e-5
    assert float((alpha[0, ..., 0] - ref_a).abs().max()) < 1e-5
    assert float(alpha.max()) > 0.5


def test_reference_network_matches_the_program():
    from benchlib.weights import build_model, make_weights
    from reference.network import OUT_KEYS, Net
    cfg = bench_tiny.tiny_config()
    w = make_weights(cfg, 11, "cpu")
    model = build_model(cfg, w, torch.device("cpu"))
    g = torch.Generator().manual_seed(1)
    a, b = (torch.rand(1, 3, 64, 96, generator=g) * 2 - 1 for _ in range(2))
    got = model.infer_pair_batch(a.permute(0, 2, 3, 1),
                                 b.permute(0, 2, 3, 1))
    ref = Net(w, cfg).forward(a, b)
    for k in OUT_KEYS:
        gap = float((got[k] - ref[k]).norm() / ref[k].norm())
        assert gap < 1e-5, (k, gap)


def _env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_exits_without_a_card():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vitl224-recon",
         "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=_env(), timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_exits_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vitl512-train",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=_env(),
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import bench_tiny\n"
        "from benchlib.runner import forbidden_modules\n"
        "for kind in ('recon', 'train', 'render'):\n"
        "    assert bench_tiny.run_tiny(kind, seconds=0.2)['correct']\n"
        "print(forbidden_modules())\n"
        % (str(BENCH / "tests"), str(BENCH), str(ROOT)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, env=_env(),
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
