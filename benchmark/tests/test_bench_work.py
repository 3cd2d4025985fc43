"""The yardstick's counts against hand counts at tiny shapes."""

import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import bench_tiny  # noqa: F401  (puts the harness on the path)
from benchlib import work
from benchlib.weights import make_weights
from reference.network import Net


@pytest.mark.parametrize("hw", [(64, 64), (32, 64)])
def test_network_flops_match_the_counted_forward(hw):
    cfg = bench_tiny.tiny_config()
    w = make_weights(cfg, 3, "cpu")
    img = torch.zeros((1, 3) + hw)
    with FlopCounterMode(display=False) as fc:
        Net(w, cfg).forward(img, img)
    assert work.network_flops(cfg, *hw) == pytest.approx(
        fc.get_total_flops(), rel=1e-12)


def test_network_flops_of_the_large_model():
    """ViT-L at 224 x 224: the encoder alone is 2 x 24 blocks of ~5.1
    GFLOP at 196 tokens, so a pair is over 0.24 TFLOP."""
    import json
    from conftest import BENCH
    with open(BENCH / "configs" / "mast3r-vitl-224.json") as f:
        cfg = json.load(f)
    t, e = 196, 1024
    block = 2 * t * e * 3 * e + 4 * t * t * e + 2 * t * e * e \
        + 4 * t * e * 4 * e
    flops = work.network_flops(cfg, 224, 224)
    assert flops > 2 * 24 * block > 0.24e12


def _hand_count(rows, h, w, tile):
    """Per pixel, walk the list front to back in float64: (evaluated,
    passing)."""
    ev = ps = 0
    for y in range(h):
        for x in range(w):
            t = 1.0
            for r in rows:
                if t < work.STOP_T:
                    break
                ev += 1
                dx, dy = x + 0.5 - r[0], y + 0.5 - r[1]
                s = 0.5 * (r[2] * dx * dx + r[4] * dy * dy) + r[3] * dx * dy
                a = r[8] * math.exp(-min(max(s, 0.0), 50.0))
                if s >= 0 and a > 1 / 255:
                    ps += 1
                    t *= 1 - min(a, 0.999)
    return ev, ps


def test_composite_work_matches_a_hand_count():
    rows = np.array([
        [8.0, 8.0, 0.01, 0.0, 0.01, 1, 0, 0, 0.9999],  # two of these stop
        [8.0, 8.0, 0.01, 0.0, 0.01, 0, 1, 0, 0.9999],
        [7.0, 9.0, 0.5, 0.1, 0.3, 0, 0, 1, 0.6],
        [100.0, 8.0, 1.0, 0.0, 1.0, 1, 1, 1, 0.9],    # never passes
    ], np.float32)
    packed = torch.as_tensor(rows)
    gidx = torch.tensor([[[0, 1, 2, 3]]], dtype=torch.int32)
    counts = torch.tensor([[4]], dtype=torch.int32)
    wk = work.composite_work(packed, gidx, counts, 16, 16, 16, chunk=2)
    ev, ps = _hand_count(rows, 16, 16, 16)
    assert (wk["evaluated"], wk["passing"]) == (ev, ps)
    assert ev < 4 * 256                       # some pixels stopped
    assert (wk["rows"], wk["slots"], wk["pixels"]) == (4, 4, 256)
    ops, nbytes = work.composite_fwd_cost(wk)
    assert ops == 15 * ev + 10 * ps
    assert nbytes == 36 * 4 + 4 * 4 + 4 * 1 + 16 * 256


def test_least_time_names_its_bound():
    assert work.least_time(67e12, 0, 67e12, 3.35e12) == (1.0, "operations")
    assert work.least_time(0, 3.35e12, 67e12, 3.35e12) == (1.0, "bytes")
