"""The `mvrecon` kind (VGGT's multi-view reconstruction) at a tiny size on
the CPU: the sound path is correct, and the float8 control and a planted
fault (each global block attending within its own frame) are not, at the
limits of `checks/vggt1b-recon32.json`; and the new cell's metric readers
on hand-made profiler events (test_bench_spans.py's pattern).

On the card, the readings of the program, the control and the fault at
the cell's own size:

    python benchmark/tests/test_bench_mvrecon.py --seeds 1 2 3 \
        [--fault frame_only_global | no_clean_up]
"""

import argparse
import json
import sys
import time

import pytest

from conftest import BENCH, ROOT

CELL = "vggt1b-recon32"


def tiny_config() -> dict:
    with open(BENCH / "configs" / "vggt-1b.json") as f:
        c = json.load(f)
    c.update(name="vggt-tiny", img_size=56, image_size=56, embed_dim=64,
             enc_depth=2, num_heads=2, depth=4, head_layers=[0, 1, 2, 3],
             dpt_features=16, dpt_out_channels=[8, 12, 16, 16],
             dpt_last_dim=8, frames_chunk_size=2, camera_trunk_depth=2,
             camera_num_heads=2, dtype="float32")
    return c


def tiny_traffic() -> dict:
    with open(BENCH / "traffic" / "mvrecon.json") as f:
        t = json.load(f)
    t.update(views=4, photo_hw=[48, 64], points=400, max_scenes_per_s=4,
             check={"scenes": 1, "views": 2})
    return t


def checks() -> dict:
    with open(BENCH / "checks" / f"{CELL}.json") as f:
        return json.load(f)


def tiny_run(seed: int = 5, seconds: float = 0.5, trace: bool = False,
             per_layer=()):
    from benchlib.manifest import Cell
    from benchlib.runner import Run
    cell = Cell("tiny.mvrecon", "vggt-tiny", "mvrecon", 1, tiny_config(),
                tiny_traffic(), [{"name": "recon_s", "unit": "s/scene"},
                                 {"name": "setup_s", "unit": "s"}],
                list(per_layer), checks())
    return Run(cell, seed, seconds, trace, "cpu")


def plant_frame_only_global(mp):
    """Each global block attends within its own frame only."""
    from starst3r_tpu_torch.models import vggt

    def frame_only(self, blk, x, rope_all):
        p = x.shape[1]
        return blk(x, (rope_all[0][:p], rope_all[1][:p]))

    mp.setattr(vggt.Aggregator, "global_block", frame_only)


def plant_no_clean_up(mp):
    """The dense points come without the cross-view clean-up."""
    from starst3r_tpu_torch import reconstruct
    real = reconstruct.Reconstruction.get_dense_pts3d
    mp.setattr(reconstruct.Reconstruction, "get_dense_pts3d",
               lambda self, clean_depth=True: real(self, False))


PLANTS = {"frame_only_global": plant_frame_only_global,
          "no_clean_up": plant_no_clean_up}


def _values(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def test_the_tiny_cell_is_correct():
    from benchlib.runner import run_cell
    r = run_cell(tiny_run(), time.perf_counter())
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0, r
    assert set(r["metrics"]) == {"recon_s", "setup_s"}
    assert max(_values(r).values()) < 1e-3, r["checks"]


def test_the_float8_control_is_not_correct():
    from benchlib.kinds.mvrecon import Workload
    run = tiny_run(seed=7)
    wl = Workload(run)
    wl.setup()
    wl.window(0.5)
    wl.release()
    sound = {c.name: c for c in wl.check()}
    lower = {c.name: c for c in wl.check(control=True)}
    assert all(c.ok for c in sound.values()), sound
    assert not lower["net_gap"].ok, lower
    assert not lower["dense_gap"].ok, lower


def test_frame_only_global_attention_is_not_correct(monkeypatch):
    from benchlib.runner import run_cell
    plant_frame_only_global(monkeypatch)
    r = run_cell(tiny_run(seed=6), time.perf_counter())
    assert not r["correct"], r["checks"]
    assert _values(r)["net_gap"] > checks()["limits"]["net_gap"]


def test_dense_points_without_their_clean_up_are_not_correct(monkeypatch):
    from benchlib.runner import run_cell
    plant_no_clean_up(monkeypatch)
    r = run_cell(tiny_run(seed=9), time.perf_counter())
    assert not r["correct"], r["checks"]
    assert _values(r)["clean_gap"] > checks()["limits"]["clean_gap"]
    assert _values(r)["dense_gap"] < 1e-6


# -- the readers on hand-made events -------------------------------------

class _Run:
    def __init__(self, events, cfg, hw=(392, 518), views=32):
        from benchlib import spans
        self.records = {"spans": spans.read(events),
                        "mvrecon.image_hw": hw, "mvrecon.views": views,
                        "mvrecon.scenes": 2}
        self.cell = type("C", (), {"config": cfg})()
        self.window_s = 4.0


def _events():
    from test_bench_spans import Ev, kernel
    events = []
    for r in range(2):                        # two requests of 4 s
        t = 4.0 * r
        events.append(Ev("bench/request", t, t + 4.0))
        stages = [("imaging/load", 0.1, 0.3), ("vggt/encode", 0.4, 0.5),
                  ("vggt/frame", 0.5, 0.6), ("vggt/global", 0.6, 1.0),
                  ("vggt/camera", 1.0, 1.1), ("vggt/heads", 1.1, 1.5),
                  ("recon/dense", 1.6, 1.8)]
        for k, (name, a, b) in enumerate(stages):
            events.append(Ev(name, t + a, t + b))
            corr = 100 * r + k
            events += [Ev("cudaLaunchKernel", t + a + 0.01, t + a + 0.02,
                          corr=corr),
                       kernel(name + "_k", t + 2.0 + 0.1 * k,
                              t + 2.0 + 0.1 * k + 0.05, corr=corr)]
        # the fused attention inside the global block: 0.25 s a scene
        events += [Ev("vggt/global_attn", t + 0.7, t + 0.8),
                   Ev("cudaLaunchKernel", t + 0.71, t + 0.72,
                      corr=100 * r + 50),
                   kernel("flash", t + 3.0, t + 3.25, corr=100 * r + 50)]
    return events


def _read(name, run):
    from benchlib.manifest import load_metric
    return load_metric(name).read(run)


def test_the_new_readers_on_hand_made_events():
    with open(BENCH / "configs" / "vggt-1b.json") as f:
        cfg = json.load(f)
    run = _Run(_events(), cfg)
    assert _read("load_s.mvrecon", run) == pytest.approx(0.2)
    for name in ("encoder_ms", "frame_ms", "dense_ms"):
        assert _read(f"{name}.mvrecon", run) == pytest.approx(50.0)
    # the global block's own kernel and its attention's
    assert _read("global_ms.mvrecon", run) == pytest.approx(300.0)
    assert _read("heads_ms.mvrecon", run) == pytest.approx(100.0)
    from benchlib import vggt_work
    attn = vggt_work.vggt_flops(cfg, 32, 392, 518)["global_attn"]
    assert _read("global_attn_roofline.mvrecon", run) == pytest.approx(
        100.0 * attn / 989e12 / 0.25)
    total = vggt_work.vggt_flops(cfg, 32, 392, 518)["total"]
    assert _read("mfu.mvrecon", run) == pytest.approx(
        100.0 * 2 * total / (4.0 * 989e12))


def test_the_new_readers_find_nothing_in_a_trace_without_spans():
    from test_bench_spans import Ev
    with open(BENCH / "configs" / "vggt-1b.json") as f:
        cfg = json.load(f)
    run = _Run([Ev("bench/request", 0.0, 1.0)], cfg)
    for name in ("load_s", "encoder_ms", "frame_ms", "global_ms",
                 "heads_ms", "dense_ms", "global_attn_roofline"):
        assert _read(f"{name}.mvrecon", run) is None, name


def test_the_counted_work_of_a_32_view_scene():
    """The reckoning of the configuration's FLOPs (PERF.md section 4): the
    global attention 24 x 4 T^2 C at T = 32 x 1,041 tokens, 57% of the
    forward."""
    from benchlib import vggt_work
    with open(BENCH / "configs" / "vggt-1b.json") as f:
        cfg = json.load(f)
    f = vggt_work.vggt_flops(cfg, 32, 392, 518)
    assert f["global_attn"] == 24 * 4.0 * 33312 ** 2 * 1024
    assert 0.55 < f["global_attn"] / f["total"] < 0.6
    assert 13e12 < f["heads"] < 16e12


if __name__ == "__main__":
    sys.path[:0] = [str(BENCH), str(ROOT)]
    from test_bench_control import readings
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--fault", default=None, choices=sorted(PLANTS))
    p.add_argument("--program-only", action="store_true")
    a = p.parse_args()
    with pytest.MonkeyPatch.context() as mp:
        if a.fault:
            PLANTS[a.fault](mp)
        for s in a.seeds:
            print(json.dumps(readings(CELL, s, a.seconds,
                                      not (a.program_only or a.fault)),
                             default=float), flush=True)
    sys.exit(0)
