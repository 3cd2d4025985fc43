"""Multi-view reconstruction requests by Fast3R: a closed loop with one
client, each request a new scene of photos (PNG files written in set-up),
through the program's `load_images` as MASt3R's (``size`` the
configuration's image size, values in [-1, 1]), `reconstruct_scene` (one
forward over all views, the cameras from its local and global pointmaps,
no pairs, no alignment) and `get_dense_pts3d(clean_depth=False)`, ending
when the cameras and the dense points are on the host.

The check, once the window has closed, on scenes drawn from the seed
among those the window finished:
  - ``net_gap``: the network's four outputs (local points and their
    confidence, global points and theirs) of views drawn from the seed,
    as the timed path produced them, against the plain float32 reference
    (`reference/fast3r.py`, TF32 off) on its own preprocessing of the
    same PNGs (`reference/preprocess.py`): the mean over the four outputs
    of each output's RMS gap in the heads' own values (`head_space`),
    pooled over the drawn scenes and views, over the larger of that
    output's reference RMS and the median output's (`mvrecon.output_gaps`'
    measure);
  - ``global_gap``: that measure's global points alone. Only the fusion
    relates a view to view 0's frame, so a fusion cut into views shows
    there first;
  - ``cam_gap``: the program's cameras of the drawn views and view 0
    against `reference.fast3r.cameras` on the program's own outputs of
    those views (as the timed path produced them): the largest of
    `camera_terms`, the focal's relative gap and that of its signed
    least-squares quotient (the program's `least_squares_focal` on view
    0's recorded global pointmap against `reference.fast3r.focal_fit`),
    and of each view's rigid motion the relative gap of the weighted
    squared residual it leaves between its local and global points, the
    gap of the rotation weighted by the clouds' singular values, and its
    determinant's distance from 1;
  - ``dense_gap``: the dense points and depths of the drawn views against
    the reference's unprojection of the program's depth with the
    program's cameras: the largest relative L2 gap of a view.

With ``control`` the reference a precision down stands in the program's
place: float8 matmuls in the encoder and the fusion, a bfloat16 camera
solve, a bfloat16 unprojection.
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
from .mvrecon import rel_gap

OUT_KEYS = ("pts_local", "conf_local", "pts_global", "conf_global")


def head_space(key: str, x: np.ndarray) -> np.ndarray:
    """An output mapped back to its head's own values, where a bfloat16
    rounding is a relative error and not an exponential one: a point's
    raw vector x / |x| log1p(|x|) (the inverse of the `exp`
    parameterisation), log(confidence - 1)."""
    x = np.asarray(x, np.float64)
    if key.startswith("conf"):
        return np.log(np.maximum(x - 1.0, 1e-30))
    d = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(d, 1e-30) * np.log1p(d)


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


def _cloud(net: Dict[str, np.ndarray]):
    """(local points (V, N, 3), global points (V, N, 3), weights (V, N)) in
    float64: what each view's Procrustes fits, weighted by the product of
    the two confidences."""
    v = np.asarray(net["pts_local"]).shape[0]
    src = np.asarray(net["pts_local"], np.float64).reshape(v, -1, 3)
    dst = np.asarray(net["pts_global"], np.float64).reshape(v, -1, 3)
    w = (np.asarray(net["conf_local"], np.float64)
         * np.asarray(net["conf_global"], np.float64)).reshape(v, -1)
    return src, dst, w


def fit_residual(cam2w, net: Dict[str, np.ndarray]) -> np.ndarray:
    """Each view's weighted squared residual of its rigid motion (cam2w's
    R, t) taking its local points onto its global points, sum_n w_n
    |R s_n + t - d_n|^2 with w the product of the two confidences, in
    float64: what the Procrustes minimises."""
    c2w = np.asarray(cam2w, np.float64)
    src, dst, w = _cloud(net)
    moved = np.einsum("vij,vnj->vni", c2w[:, :3, :3], src) \
        + c2w[:, None, :3, 3]
    return np.sum(w * np.sum(np.square(moved - dst), -1), -1)


def alignment(cam2w, net: Dict[str, np.ndarray]):
    """(tr(R C), |C|_*) of each view, C = sum_n w_n (s_n - mu_s)(d_n -
    mu_d)^T the weighted cross-covariance of its centred local and global
    points, in float64: the part of the fit's residual that the rotation
    moves, -2 tr(R C), and its largest value over the rotations and
    reflections, the sum of C's singular values."""
    rot = np.asarray(cam2w, np.float64)[:, :3, :3]
    src, dst, w = _cloud(net)
    total = np.sum(w, -1)[:, None, None]
    mu_s = np.sum(w[..., None] * src, 1, keepdims=True) / total
    mu_d = np.sum(w[..., None] * dst, 1, keepdims=True) / total
    cov = np.einsum("vn,vni,vnj->vij", w, src - mu_s, dst - mu_d)
    return (np.einsum("vji,vij->v", rot, cov),
            np.linalg.svd(cov, compute_uv=False).sum(-1))


def camera_terms(cam2w, focal, quotient, ref_cam2w, ref_focal,
                 ref_quotient, net: Dict[str, np.ndarray]
                 ) -> Dict[str, float]:
    """The compared parts of the cameras, each the largest over the views
    given:
      - ``focal``: the focal's relative gap, and ``quotient``: that of the
        least-squares quotient it is clamped from (signed; negative on
        random weights, whose focal both sides clamp to 1e-8);
      - ``fit``: the relative gap of the fit's residual (`fit_residual`);
      - ``rotation``: the gap of tr(R C) over |C|_* (`alignment`). Near
        the optimum it is half the sum over the rotation's axes of its
        angle's square times that axis's singular-value sum (sigma_i +
        sigma_j), over |C|_*: a rotation off along an axis the clouds pin
        reads high, one off along an axis they leave nearly free (which
        rounding alone moves by up to 8e-3 here, PERF.md section 2) low;
      - ``proper``: |det R - 1|, 2 for a reflection."""
    got = fit_residual(cam2w, net)
    ref = fit_residual(ref_cam2w, net)
    a_got, nuc = alignment(cam2w, net)
    a_ref, _ = alignment(ref_cam2w, net)
    rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    det = np.linalg.det(np.asarray(cam2w, np.float64)[:, :3, :3])
    return {"focal": rel(focal, ref_focal),
            "quotient": rel(quotient, ref_quotient),
            "fit": worst(*(np.abs(got - ref) / np.maximum(ref, 1e-300))),
            "rotation": worst(*(np.abs(a_got - a_ref)
                                / np.maximum(nuc, 1e-300))),
            "proper": worst(*np.abs(det - 1.0))}


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
        from ..fast3r_weights import build_model, make_weights

        run, tr = self.run, self.tr
        self.dev = torch.device(run.device)
        # the model first: a program without it stops here, before the
        # photos are written
        self.weight_seed = run.torch_seed("weights")
        with run.phase("weights"):
            weights = make_weights(self.cfg, self.weight_seed, self.dev)
            self.model = build_model(self.cfg, weights, self.dev)
            del weights
        self._tmp = tempfile.TemporaryDirectory(prefix="bench_ffrecon_")
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

        with run.phase("photos"), ThreadPoolExecutor(8) as pool:
            self.files = list(pool.map(write, range(n)))
        self.warm_files, self.files = (self.files[:tr["warmup_scenes"]],
                                       self.files[tr["warmup_scenes"]:])
        # which views each scene keeps for the check: drawn from the seed,
        # and view 0, whose global pointmap gives the focal
        vrng = run.rng("views")
        self.keep = [sorted(vrng.choice(tr["views"], tr["check"]["views"],
                                        replace=False).tolist())
                     for _ in self.files]
        self._install_recorder()
        with run.phase("warm-up"):
            for files in self.warm_files:
                self._request(files, keep=())

    @staticmethod
    def recorded(keep) -> List[int]:
        """The views whose outputs a request keeps: view 0 and ``keep``."""
        return sorted({0, *keep}) if keep else []

    def _install_recorder(self):
        """Keep, per request, the network's outputs of the recorded views
        as the timed path produced them."""
        model, cur = self.model, self._cur
        infer = model.infer

        def recorded(images):
            out = infer(images)
            views = cur.get("views")
            if views:
                cur["net"] = {f: out[f][views].float().cpu().numpy()
                              for f in OUT_KEYS}
            return out

        model.infer = recorded

    # -- the request ---------------------------------------------------
    def _request(self, files, keep) -> dict:
        import torch
        from starst3r_tpu_torch import load_images, reconstruct_scene
        keep = list(keep)
        views = self.recorded(keep)
        self._cur.clear()
        self._cur["views"] = views
        with torch.profiler.record_function("bench/request"):
            imgs = load_images(files, size=self.cfg["image_size"])
            rec, _ = reconstruct_scene(self.model, imgs, device=self.dev)
            pts, depths, _ = rec.get_dense_pts3d(clean_depth=False)
        return {"cam2w": rec.cam2w[views], "focal": float(
                    rec.intrinsics[0, 0, 0]),
                "depth": rec.depth[keep], "depth_conf": rec.depth_conf[keep],
                "K": rec.intrinsics[keep], "pose": rec.cam2w[keep],
                "pts": np.stack([pts[i] for i in keep]) if keep else None,
                "depths": (np.stack([depths[i] for i in keep]) if keep
                           else None),
                "hw": rec.imgs[0].shape[:2], "keep": list(keep),
                "views": views, "net": self._cur.get("net")}

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
            "ffrecon.scenes": len(self.done),
            "ffrecon.views": self.tr["views"],
            "ffrecon.image_hw": (next(iter(self.done.values()))["hw"]
                                 if self.done else None),
            "ffrecon.latencies": list(self.latencies)})

    def end_to_end(self) -> Dict[str, float]:
        n = len(self.done)
        return {"recon_s": self.run.window_s / n if n else float("inf")}

    def release(self):
        self.model = None

    # -- the check -------------------------------------------------------
    def check(self, control: bool = False) -> List[Check]:
        """The compared numbers over the scenes drawn for the check."""
        import torch
        from reference import fast3r as rf
        from reference.precision import fp8, tf32
        from reference.preprocess import load
        from ..fast3r_weights import make_weights

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
        net = rf.Fast3R(w, self.cfg)
        net_lo = rf.Fast3R(w, self.cfg, quant=fp8)
        progs, refs = [], []
        other = {"cam_gap": 0.0, "dense_gap": 0.0}
        parts: Dict[str, float] = {}
        size = self.cfg["image_size"]
        with tf32(False), torch.no_grad():
            for k in chosen:
                out = self.done[k]
                keep = out["keep"]
                sel = [out["views"].index(v) for v in keep]
                imgs = torch.as_tensor(np.stack([load(f, size)
                                                 for f in self.files[k]]),
                                       device=dev)
                ref = net.forward(imgs)
                refs.append({f: ref[f][keep].float().cpu().numpy()
                             for f in OUT_KEYS})
                del ref
                progs.append(None if control else
                             {f: out["net"][f][sel] for f in OUT_KEYS})
                for name, g in self._camera_dense_gaps(out,
                                                       control).items():
                    if name in other:
                        other[name] = worst(other[name], g)
                    else:
                        parts[name] = worst(parts.get(name, 0.0), g)
                if control:
                    lo = net_lo.forward(imgs)
                    progs[-1] = {f: lo[f][keep].float().cpu().numpy()
                                 for f in OUT_KEYS}
                    del lo
        del w, net, net_lo
        pool = lambda outs: {f: np.concatenate([o[f].reshape(-1)
                                                 for o in outs])
                             for f in OUT_KEYS}
        per_key = output_gaps(pool(progs), pool(refs))
        gaps = dict(other, net_gap=float(np.mean(list(per_key.values()))),
                    global_gap=per_key["pts_global"])
        self.run.records["check_details"] = {
            "net_gap_by_output": per_key, "cam_gap_by_term": parts,
            "scenes": chosen,
            "latencies (min, median, max)": [
                min(self.latencies), float(np.median(self.latencies)),
                max(self.latencies)] if self.latencies else None}
        return [Check(k, gaps[k], v) for k, v in self.limits.items()]

    def _camera_dense_gaps(self, out, control: bool) -> Dict[str, float]:
        """``cam_gap`` and ``dense_gap`` of one scene's recorded views
        (with ``control`` the reference's own bfloat16 solve and
        unprojection stand in for the program's)."""
        import torch
        from reference import fast3r as rf
        h, w = out["hw"]
        t = lambda x, dt=torch.float32: torch.as_tensor(
            np.asarray(x), device=self.dev, dtype=dt)
        net = [t(out["net"][f]) for f in OUT_KEYS]
        ref_c2w, ref_k = rf.cameras(*net)
        ref_q = rf.focal_fit(net[2][0], net[3][0])
        if control:
            got_c2w, got_k = rf.cameras(*net, dtype=torch.bfloat16)
            got_c2w, focal = got_c2w.cpu().numpy(), float(got_k[0, 0, 0])
            quotient = rf.focal_fit(net[2][0], net[3][0], torch.bfloat16)
        else:
            from starst3r_tpu_torch.utils.camera import least_squares_focal
            got_c2w, focal = out["cam2w"], out["focal"]
            # view 0 is the first recorded view
            quotient = float(least_squares_focal(
                net[2][0], torch.tensor([w / 2.0, h / 2.0],
                                        device=self.dev), net[3][0]))
        terms = camera_terms(got_c2w, focal, quotient,
                             ref_c2w.cpu().numpy(), float(ref_k[0, 0, 0]),
                             ref_q, out["net"])
        keep = out["keep"]
        c = len(keep)

        def unproject(dt):
            pts, d, _ = rf.unproject(t(out["depth"].reshape(c, -1), dt),
                                     t(out["depth_conf"].reshape(c, -1), dt),
                                     t(out["K"], dt), t(out["pose"], dt),
                                     h, w, clean=False)
            return [x.float().cpu().numpy() for x in (pts, d)]

        ref = unproject(torch.float32)
        got = (unproject(torch.bfloat16) if control
               else [out["pts"].reshape(c, -1, 3), out["depths"]])
        dense = 0.0
        for i in range(c):
            dense = worst(dense, rel_gap(got[0][i], ref[0][i]),
                          rel_gap(got[1][i], ref[1][i]))
        # the terms apart, for the check's details
        return dict(terms, cam_gap=worst(*terms.values()), dense_gap=dense)
