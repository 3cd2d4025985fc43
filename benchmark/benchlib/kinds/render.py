"""Novel-view rendering: a closed loop with one viewer; each request
renders one view along an orbit of the trained scene with the program's
`splat.train.render` and copies the image to the host.

Set-up builds the scene's Gaussians as the training kind does and trains
them a fixed number of steps with `run_optim`, so they have left their
start; every seed renders the same set of views, in its own order.

The check, once the window has closed, renders the requests drawn from
the seed with the plain reference rasterizer from the Gaussians the
requests rendered (the program's trained state, which the training cell
checks): ``render_gap_p90``, the largest over the sampled images of the
90th percentile of a pixel channel's absolute gap. A float32 reordering
of the projection moves a Gaussian across a tile's edge or a depth key's
step now and then, which changes a few pixels by a visible amount on
every seed; the 90th percentile holds the other nine tenths of the image
to float32 round-off, where a lower precision moves every pixel. A fault
confined to a tile, a row of tiles or an edge leaves the 90th percentile
as it was, so a second number is held: ``render_tile_bad``, the largest
share, over the sampled images' tiles (the configuration's tile size), of
a tile's pixels that some channel misses by more than `TILE_GAP`. Sound
runs' flips touch a Gaussian's footprint, a few pixels of a tile (an
eighth at most over 48 images at 512 x 384); a tile computed wrong misses
on most of its pixels.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..runner import Check, worst
from ..scenes import orbit_views
from . import splatbase

QUANTILE = 0.9
TILE_GAP = 1e-1


def tile_bad(got: np.ndarray, want: np.ndarray, tile: int,
             gap: float = TILE_GAP) -> float:
    """The largest share, over the image's ``tile`` x ``tile`` tiles (the
    edge's partial tiles by their own pixel count), of a tile's pixels
    whose largest channel gap is over ``gap``."""
    bad = (np.abs(got - want).max(-1) > gap).astype(np.float64)
    h, w = bad.shape
    th, tw = -(-h // tile), -(-w // tile)
    pad = np.zeros((th * tile, tw * tile))
    cnt = np.zeros_like(pad)
    pad[:h, :w], cnt[:h, :w] = bad, 1.0
    per = lambda x: x.reshape(th, tile, tw, tile).sum((1, 3))
    return float((per(pad) / per(cnt)).max())


class Workload:
    def __init__(self, run):
        self.run = run
        self.tr = run.cell.traffic
        # limits of the compared numbers (checks/<cell>.json)
        self.limits = run.cell.checks["limits"]
        self.attempted = 0
        self.failed = 0
        self.latencies: List[float] = []
        self.kept: Dict[int, np.ndarray] = {}
        self.recorder = None

    def setup(self):
        import torch
        from starst3r_tpu_torch.splat.train import run_optim

        run, t = self.run, self.tr
        self.dev = torch.device(run.device)
        with run.phase("scene"):
            pts, cols, views, w2c, Ks = splatbase.make_scene(run)
        self.scfg = splatbase.splat_config(run)
        with run.phase("init"):
            state = splatbase.program_state(
                pts, cols, self.scfg, run.torch_seed("gaussians"),
                self.scfg.mcmc_refine_start, self.dev)
        with run.phase("training"):
            state, _ = run_optim(state, views, w2c, Ks, t["train_steps"],
                                 self.scfg, enable_pruning=True)
        self.params, self.n_alive = state.params, state.n_alive
        del state
        self.h, self.w = views.shape[1:3]
        orbit = orbit_views(t["views"], t["scene"]["spread"],
                            t["scene"]["cameras"])
        order = run.rng("order").permutation(t["views"])
        self.w2c = torch.as_tensor(orbit[order], device=self.dev)
        self.K = torch.as_tensor(Ks[:1], device=self.dev)
        self.sample = sorted(run.rng("sample").choice(
            t["check"]["first"], t["check"]["requests"],
            replace=False).tolist())
        with run.phase("warm-up"):
            for k in range(t["warmup_requests"]):
                self._request(k)

    def _request(self, k: int) -> np.ndarray:
        from starst3r_tpu_torch.splat.train import render
        v = k % self.w2c.shape[0]
        rgb, _, _ = render(self.params, self.w2c[v:v + 1], self.K, self.w,
                           self.h, self.scfg, n_alive=self.n_alive)
        return rgb[0].cpu().numpy()

    def window(self, seconds: float):
        import torch
        if self.run.trace:
            self.recorder = splatbase.KernelRecorder()
        t0 = time.perf_counter()
        k = 0
        try:
            while (time.perf_counter() - t0 - self.run.tracer.paused_s
                   < seconds):
                self.attempted += 1
                self.run.tracer.tick()
                ts = time.perf_counter()
                with torch.profiler.record_function("bench/request"):
                    img = self._request(k)
                self.latencies.append(time.perf_counter() - ts)
                if k in self.sample:
                    self.kept[k] = img
                k += 1
        finally:
            if self.recorder is not None:
                self.recorder.close()
        self.run.records.update({
            "render.requests": len(self.latencies),
            "splat.hw": (self.h, self.w), "splat.gaussians": self.n_alive,
            "splat.kernels": (self.recorder.last if self.recorder else {}),
            "splat.tile": self.scfg.tile_size})

    def end_to_end(self) -> Dict[str, float]:
        return {"render_ms_p95": float(np.percentile(
            np.asarray(self.latencies) * 1e3, 95))}

    def release(self):
        self.run.records.pop("splat.kernels", None)

    def check(self, control: bool = False) -> List[Check]:
        """``render_gap_p90`` and ``render_tile_bad``; with ``control`` the
        reference with TF32 on stands in the program's place (the bfloat16
        readings are printed beside it)."""
        import torch
        from reference.precision import bf16, tf32
        from reference.raster import render_one

        g = {"means": self.params["means"], "quats": self.params["quats"],
             "scales": self.params["scales"],
             "opacities": torch.where(
                 torch.arange(self.params["opacities"].shape[0],
                              device=self.dev) < self.n_alive,
                 self.params["opacities"],
                 torch.zeros_like(self.params["opacities"])),
             "sh": self.params["shN"]}
        s = self.run.cell.config["splat"]
        gap = 0.0 if self.kept else float("inf")
        bad = gap
        p90 = lambda d: float(np.quantile(np.abs(d), QUANTILE))

        def ref(v, on=False, quant=None):
            with tf32(on), torch.no_grad():
                return render_one(g, self.w2c[v], self.K[0], self.w, self.h,
                                  s["tile_size"], s["max_tiles_per_gaussian"],
                                  s["max_per_tile"], quant)[0].cpu().numpy()

        stats = {}
        for k, img in self.kept.items():
            v = k % self.w2c.shape[0]
            want = ref(v)
            got = ref(v, on=True) if control else img
            gap = worst(gap, p90(got - want))
            bad = worst(bad, tile_bad(got, want, s["tile_size"]))
            variants = {"program": img}
            if control:
                variants.update(tf32=got, bf16=ref(v, quant=bf16))
            for name, x in variants.items():
                d = np.abs(x - want).ravel()
                q = np.quantile(d, [0.5, 0.9, 0.99])
                row = [float(d.mean()), *map(float, q), float(d.max()),
                       *(tile_bad(x, want, s["tile_size"], g)
                         for g in (1e-3, 1e-2, 1e-1))]
                old = stats.get(name, [0.0] * len(row))
                stats[name] = [max(a, b) for a, b in zip(old, row)]
        self.run.records["check_details"] = {
            f"{k} (mean, p50, p90, p99, max, tile_bad at 1e-3, 1e-2, 1e-1)":
            v for k, v in stats.items()}
        gaps = {"render_gap_p90": gap, "render_tile_bad": bad}
        return [Check(k, gaps[k], v) for k, v in self.limits.items()]
