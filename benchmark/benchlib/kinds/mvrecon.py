"""Multi-view reconstruction requests by a feed-forward network (VGGT): a
closed loop with one client, each request a new scene of photos (PNG files
written in set-up), through the program's `load_images` in VGGT's crop
mode, `reconstruct_scene` (one forward over all views, no pairs, no
alignment) and `get_dense_pts3d(clean_depth=True)`, ending when the
cameras and the cleaned dense points are on the host.

The check, once the window has closed, on scenes drawn from the seed
among those the window finished:
  - ``net_gap``: the network's outputs as the timed path produced them
    (the pose encodings of every view; depth, its confidence, the world
    points and their confidence of views drawn from the seed) against the
    plain float32 reference (`reference/vggt.py`, TF32 off) on its own
    preprocessing of the same PNGs: the mean over the five outputs of each
    output's RMS gap in the heads' own values (`head_space`), pooled over
    the drawn scenes and views, over the larger of that output's reference
    RMS and the median output's. (Pooled, not the worst scene's: a sound
    run's gap is bfloat16 noise that varies from scene to scene, and a
    fault's shows in every scene);
  - ``pose_gap``: that measure's pose encodings alone. The camera head
    attends across all views' camera tokens, so a fault that cuts the
    views apart shows in the poses first, and the poses' bfloat16 noise is
    the smallest of the five outputs';
  - ``dense_gap``: the dense points and depths of the drawn views against
    the reference's cameras from the program's pose encodings and its
    unprojection of the program's depth: the largest relative L2 gap of a
    view;
  - ``clean_gap``: the clean-up's verdicts (a point in front of what
    another view sees there gets confidence 1) of the drawn views against
    the reference's on the same cameras and depth: the largest share of a
    view's pixels on which they differ. A share, not a norm: the verdict
    turns on the nearest pixel another view's projection rounds to and on
    a 5% depth margin, so a one-ulp difference in a projection flips the
    odd verdict of a sound run.

With ``control`` the reference a precision down stands in the program's
place: float8 matmuls in the encoder and the aggregator, and a bfloat16
unprojection.
"""

from __future__ import annotations

import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..runner import Check, worst
from ..scenes import make_views, write_pngs

OUT_KEYS = ("pose_enc", "depth", "depth_conf", "world_points",
            "world_points_conf")


def head_space(key: str, x: np.ndarray) -> np.ndarray:
    """An output mapped back to its head's own values, where a bfloat16
    rounding is a relative error and not an exponential one: log depth,
    log(confidence - 1), sign(x) log1p(|x|) of a world point; the pose
    encoding as it is."""
    x = np.asarray(x, np.float64)
    if key == "depth":
        return np.log(np.maximum(x, 1e-30))
    if key.endswith("conf"):
        return np.log(np.maximum(x - 1.0, 1e-30))
    if key == "world_points":
        return np.sign(x) * np.log1p(np.abs(x))
    return x


def output_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
                ) -> Dict[str, float]:
    """Each output's RMS gap in head space over the larger of its
    reference's RMS and the median output's."""
    hp = {f: head_space(f, prog[f]) for f in OUT_KEYS}
    hr = {f: head_space(f, ref[f]) for f in OUT_KEYS}
    rms = lambda x: float(np.sqrt(np.mean(np.square(x))))
    scale = {f: rms(hr[f]) for f in OUT_KEYS}
    med = float(np.median(list(scale.values())))
    return {f: rms(hp[f] - hr[f]) / max(scale[f], med, 1e-30)
            for f in OUT_KEYS}


def rel_gap(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


class Workload:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic
        self.limits = run.cell.checks["limits"]
        self.attempted = 0
        self.failed = 0
        self.latencies: List[float] = []
        self.done: Dict[int, dict] = {}
        self._cur: dict = {}

    # -- set-up --------------------------------------------------------
    def setup(self):
        import torch
        from ..vggt_weights import build_model, make_weights

        run, tr = self.run, self.tr
        self.dev = torch.device(run.device)
        self._tmp = tempfile.TemporaryDirectory(prefix="bench_mvrecon_")
        rng = run.rng("scenes")
        # enough new scenes for the window at up to max_scenes_per_s
        n = int(np.ceil(run.seconds * tr["max_scenes_per_s"])) \
            + tr["warmup_scenes"]
        seeds = [int(rng.integers(0, 2 ** 31)) for _ in range(n)]

        def write(k):
            views = make_views(tr["views"], tuple(tr["photo_hw"]),
                               seed=seeds[k], n_points=tr["points"],
                               turn=tr["turn"])
            return write_pngs(views, Path(self._tmp.name), f"s{k:03d}")

        with run.phase("photos"), ThreadPoolExecutor(4) as pool:
            self.files = list(pool.map(write, range(n)))
        self.warm_files, self.files = (self.files[:tr["warmup_scenes"]],
                                       self.files[tr["warmup_scenes"]:])
        # which views' dense outputs each scene keeps for the check
        vrng = run.rng("views")
        self.keep = [sorted(vrng.choice(tr["views"], tr["check"]["views"],
                                        replace=False).tolist())
                     for _ in self.files]
        self.weight_seed = run.torch_seed("weights")
        with run.phase("weights"):
            weights = make_weights(self.cfg, self.weight_seed, self.dev)
            self.model = build_model(self.cfg, weights, self.dev)
            del weights
        self._install_recorder()
        with run.phase("warm-up"):
            for files in self.warm_files:
                self._request(files, keep=())

    def _install_recorder(self):
        """Keep, per request, the network's outputs of the chosen views as
        the timed path produced them (every view's pose encoding)."""
        model, cur = self.model, self._cur
        infer = model.infer

        def recorded(images):
            out = infer(images)
            keep = cur.get("keep", ())
            if keep:
                cur["net"] = {f: (out[f] if f == "pose_enc" else
                                  out[f][list(keep)]).float().cpu().numpy()
                              for f in OUT_KEYS}
            return out

        model.infer = recorded

    # -- the request ---------------------------------------------------
    def _request(self, files, keep) -> dict:
        import torch
        from starst3r_tpu_torch import load_images, reconstruct_scene
        self._cur.clear()
        self._cur["keep"] = keep
        with torch.profiler.record_function("bench/request"):
            imgs = load_images(files, size=self.cfg["image_size"],
                               mode="crop")
            rec, _ = reconstruct_scene(self.model, imgs, device=self.dev)
            pts, depths, confs = rec.get_dense_pts3d(clean_depth=True)
        return {"depth": rec.depth, "depth_conf": rec.depth_conf,
                "pts": np.stack([pts[i] for i in keep]) if keep else None,
                "depths": (np.stack([depths[i] for i in keep]) if keep
                           else None),
                "confs": np.stack([confs[i] for i in keep]) if keep else None,
                "hw": rec.imgs[0].shape[:2], "keep": list(keep),
                "net": self._cur.get("net")}

    def window(self, seconds: float):
        t0 = time.perf_counter()
        for k, files in enumerate(self.files):
            if (time.perf_counter() - t0 - self.run.tracer.paused_s
                    >= seconds):
                break
            self.attempted += 1
            self.run.tracer.tick()
            ts = time.perf_counter()
            try:
                out = self._request(files, self.keep[k])
            except Exception:       # a failed request is counted, not fatal
                traceback.print_exc(file=sys.stderr)
                self.failed += 1
                continue
            self.latencies.append(time.perf_counter() - ts)
            self.done[k] = out
        self.run.records.update({
            "mvrecon.scenes": len(self.done),
            "mvrecon.views": self.tr["views"],
            "mvrecon.image_hw": (next(iter(self.done.values()))["hw"]
                                 if self.done else None),
            "mvrecon.latencies": list(self.latencies)})

    def end_to_end(self) -> Dict[str, float]:
        n = len(self.done)
        return {"recon_s": self.run.window_s / n if n else float("inf")}

    def release(self):
        self.model = None

    # -- the check -------------------------------------------------------
    def check(self, control: bool = False) -> List[Check]:
        """The compared numbers over the scenes drawn for the check."""
        import torch
        from reference import vggt as rv
        from reference.precision import fp8, tf32
        from ..vggt_weights import make_weights

        done = sorted(self.done)
        if not done:
            return [Check(k, float("inf"), v)
                    for k, v in self.limits.items()]
        rng = self.run.rng("check")
        chosen = sorted(rng.choice(done, min(len(done),
                                             self.tr["check"]["scenes"]),
                                   replace=False).tolist())
        dev = self.dev
        w = make_weights(self.cfg, self.weight_seed, dev)
        net = rv.VGGT(w, self.cfg)
        net_lo = rv.VGGT(w, self.cfg, quant=fp8)
        progs, refs = [], []
        dense = {"dense_gap": 0.0, "clean_gap": 0.0}
        size = self.cfg["image_size"]
        with tf32(False), torch.no_grad():
            for k in chosen:
                out = self.done[k]
                keep = out["keep"]
                imgs = torch.as_tensor(np.stack([rv.load_crop(f, size)
                                                 for f in self.files[k]]),
                                       device=dev)
                ref = self._outputs(net.forward(imgs), keep)
                prog = (self._outputs(net_lo.forward(imgs), keep) if control
                        else out["net"])
                progs.append(prog)
                refs.append(ref)
                for name, g in self._dense_gaps(out, control).items():
                    dense[name] = worst(dense[name], g)
        del w, net, net_lo
        pool = lambda outs: {f: np.concatenate([o[f].reshape(-1)
                                                 for o in outs])
                             for f in OUT_KEYS}
        per_key = output_gaps(pool(progs), pool(refs))
        gaps = dict(dense, net_gap=float(np.mean(list(per_key.values()))),
                    pose_gap=per_key["pose_enc"])
        self.run.records["check_details"] = {
            "net_gap_by_output": per_key, "scenes": chosen,
            "latencies (min, median, max)": [
                min(self.latencies), float(np.median(self.latencies)),
                max(self.latencies)] if self.latencies else None}
        return [Check(k, gaps[k], v) for k, v in self.limits.items()]

    @staticmethod
    def _outputs(out, keep) -> Dict[str, np.ndarray]:
        return {f: (out[f] if f == "pose_enc" else out[f][keep])
                .float().cpu().numpy() for f in OUT_KEYS}

    def _dense_gaps(self, out, control: bool) -> Dict[str, float]:
        """``dense_gap`` and ``clean_gap`` of one scene's kept views: the
        program's dense output against the reference's unprojection of the
        program's pose encodings and depth (with ``control`` the
        reference's own in bfloat16 stands in for the program's)."""
        import torch
        from reference import vggt as rv
        h, w = out["hw"]
        keep = out["keep"]
        t = lambda x, dt=torch.float32: torch.as_tensor(
            np.asarray(x), device=self.dev, dtype=dt)
        s = out["depth"].shape[0]
        pose = out["net"]["pose_enc"]

        def unproject(dt):
            c2w, K = rv.cameras(t(pose, dt), h, w)
            pts, d, c = rv.unproject(t(out["depth"].reshape(s, -1), dt),
                                     t(out["depth_conf"].reshape(s, -1), dt),
                                     K, c2w, h, w)
            return [x[keep].float().cpu().numpy() for x in (pts, d, c)]

        ref = unproject(torch.float32)
        got = (unproject(torch.bfloat16) if control
               else [out["pts"], out["depths"], out["confs"]])
        dense, clean = 0.0, 0.0
        for i in range(len(keep)):
            dense = worst(dense, rel_gap(got[0][i], ref[0][i]),
                          rel_gap(got[1][i], ref[1][i]))
            clean = worst(clean, float(np.mean((got[2][i] == 1.0)
                                               != (ref[2][i] == 1.0))))
        return {"dense_gap": dense, "clean_gap": clean}
