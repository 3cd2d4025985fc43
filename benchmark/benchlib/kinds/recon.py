"""Reconstruction requests: a closed loop with one client, each request a
new scene of photos (PNG files written in set-up), through the program's
`load_images` and `reconstruct_scene`, ending when poses, intrinsics and
dense points are on the host.

The check, once the window has closed, on scenes drawn from the seed
among those the window finished:
  - ``net_gap``: the network's outputs on pairs drawn from the seed (kept
    from the timed path as it produced them) against the plain float32
    network on the reference's own preprocessing of the same PNGs: the
    mean over the eight outputs of each output's largest gap over the
    pairs (`output_gaps`), each output mapped back to its head's values
    (`head_space`). (The largest single gap swings with the seed past the
    float8 control's lowest reading; the mean does not, and one output
    wholly wrong still moves it by an eighth);
  - ``ga_loss_gap``: the alignment's answer (K, cam2w, core depth) scored
    by the reference's objective, on the correspondences and spanning tree
    the program built for that scene (the stages between the network and
    the alignment are followed, not re-derived), against the loss the
    program reported for its last step, relative. The shortfall of the
    answer against the reference's own alignment from the same start,
    max(0, L(program) - L(ref)) / (L(start) - L(ref)), is printed beside
    the checks and not compared: two float32 alignments of a random
    network's scene end in different minima, and a sound answer's loss
    may even end above the start's (the coarse phase minimises another
    loss), so no loss tells a stuck alignment from a sound one;
  - ``ga_still``: how far the reference's alignment moved from the start
    over how far the program's answer moved (`move`: each of K, cam2w and
    the core depth by its change relative to its start, in quadrature).
    Two sound alignments end in different minima at comparable distances
    (sound runs read 0.8 to 3.4); an alignment that keeps its start moves
    by round-off or not at all, and reads 1e3 to 1e31;
  - ``dense_gap``: the dense points against the reference's unprojection
    of the program's answer: the largest relative L2 gap of a camera.
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

OUT_KEYS = ("pts1", "conf1", "pts2", "conf2", "desc1", "desc2",
            "desc_conf1", "desc_conf2")


def head_space(key: str, x: np.ndarray) -> np.ndarray:
    """An output mapped back to the heads' own values, where a bfloat16
    rounding is a relative error and not an exponential one: a point's
    direction times log1p of its norm, log(confidence - 1); descriptors
    as they are."""
    x = np.asarray(x, np.float64)
    if key.startswith("pts"):
        n = np.linalg.norm(x, axis=-1, keepdims=True)
        return x / np.maximum(n, 1e-30) * np.log1p(n)
    if "conf" in key:
        return np.log(np.maximum(x - 1.0, 1e-30))
    return x


def output_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
                ) -> Dict[str, float]:
    """Each output's gap in the heads' values: the root mean square of the
    difference over the larger of that output's reference root mean square
    and the median output's, as the training check takes leaves (a random
    network's raw confidences sit near zero, where a relative gap swings
    by its nature)."""
    hp = {f: head_space(f, prog[f]) for f in OUT_KEYS}
    hr = {f: head_space(f, ref[f]) for f in OUT_KEYS}
    rms = lambda x: float(np.sqrt(np.mean(np.square(x))))
    scale = {f: rms(hr[f]) for f in OUT_KEYS}
    med = float(np.median(list(scale.values())))
    return {f: rms(hp[f] - hr[f]) / max(scale[f], med, 1e-30)
            for f in OUT_KEYS}


def move(answer, start) -> float:
    """How far an answer (K, cam2w, core depth) lies from the start: each
    tensor's change relative to its start's norm, in quadrature."""
    return float(np.sqrt(sum(rel_gap(a, s) ** 2
                             for a, s in zip(answer, start))))


def rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


class Workload:
    def __init__(self, run):
        self.run = run
        self.cfg = run.cell.config
        self.tr = run.cell.traffic
        # limits of the compared numbers (checks/<cell>.json)
        self.limits = run.cell.checks["limits"]
        self.attempted = 0
        self.failed = 0
        self.latencies: List[float] = []
        self.done: Dict[int, dict] = {}
        self._cur: dict = {}
        self._patched = []

    # -- set-up --------------------------------------------------------
    def setup(self):
        import torch
        from starst3r_tpu_torch.config import Config, GAConfig
        from starst3r_tpu_torch.utils.metrics import MetricsLogger
        from ..weights import build_model, make_weights

        run, tr = self.run, self.tr
        self.dev = torch.device(run.device)
        self._tmp = tempfile.TemporaryDirectory(prefix="bench_recon_")
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
        # which pairs' network outputs each scene keeps for the check
        n_pairs = tr["views"] * (tr["views"] - 1)
        prng = run.rng("pairs")
        self.keep = [sorted(prng.choice(n_pairs, tr["check"]["pairs"],
                                        replace=False).tolist())
                     for _ in self.files]
        self.weight_seed = run.torch_seed("weights")
        with run.phase("weights"):
            weights = make_weights(self.cfg, self.weight_seed, self.dev)
            self.model = build_model(self.cfg, weights, self.dev)
            del weights
        self.pcfg = Config(ga=GAConfig(**tr["ga"]))
        self.logger = MetricsLogger()
        self._install_recorders()
        with run.phase("warm-up"):
            for files in self.warm_files:
                self._request(files, keep=())
        self.logger.records.clear()

    def _install_recorders(self):
        """Keep, per request, the outputs of the chosen pairs as the
        timed path produced them and the alignment's inputs."""
        import starst3r_tpu_torch.reconstruct as rmod
        model, cur = self.model, self._cur
        infer = model.infer_pairs

        def infer_pairs(images, pair_indices, batch_size=8, sharding=None):
            preds = infer(images, pair_indices, batch_size=batch_size,
                          sharding=sharding)
            for k in cur.get("keep", ()):
                p = preds[k]
                cur.setdefault("net", []).append(
                    ((p.idx1, p.idx2),
                     {f: getattr(p, f).float().cpu().numpy()
                      for f in OUT_KEYS}))
            return preds

        ga = rmod.run_global_alignment

        def run_global_alignment(data, mst, cfg, *args, **kw):
            cur["ga_in"] = (data, mst)
            return ga(data, mst, cfg, *args, **kw)

        model.infer_pairs = infer_pairs
        rmod.run_global_alignment = run_global_alignment
        self._patched.append((rmod, "run_global_alignment", ga))

    # -- the request ---------------------------------------------------
    def _request(self, files, keep) -> dict:
        import torch
        from starst3r_tpu_torch import load_images, reconstruct_scene
        self._cur.clear()
        self._cur["keep"] = keep
        with torch.profiler.record_function("bench/request"):
            imgs = load_images(files, size=self.cfg["image_size"])
            rec, _ = reconstruct_scene(
                self.model, imgs, device=self.dev, config=self.pcfg,
                pair_graph=self.tr["pair_graph"], logger=self.logger)
            pts, depths, _ = rec.get_dense_pts3d(clean_depth=True)
        return {"cam2w": rec.cam2w, "K": rec.intrinsics,
                "loss_fine": rec.losses[1],
                "core_depth": rec.core_depth,
                "anchor_idx": np.stack([v.anchor_idx for v in rec.views]),
                "anchor_offset": np.stack([v.anchor_offset
                                           for v in rec.views]),
                "conf": np.stack([v.conf.reshape(-1) for v in rec.views]),
                "pts": np.stack(pts), "depths": np.stack(depths),
                "hw": rec.imgs[0].shape[:2],
                "net": self._cur.get("net", []),
                "ga_in": self._cur.get("ga_in")}

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
        ga = [r["ga"] for r in self.logger.records if "ga" in r]
        inf = [r["inference"] for r in self.logger.records
               if "inference" in r]
        self.run.records.update({
            "recon.scenes": len(self.done),
            "recon.pairs": self.tr["views"] * (self.tr["views"] - 1),
            "recon.image_hw": (next(iter(self.done.values()))["hw"]
                               if self.done else None),
            "recon.ga_s": ga, "recon.inference_s": inf,
            "recon.latencies": list(self.latencies)})

    def end_to_end(self) -> Dict[str, float]:
        n = len(self.done)
        return {"recon_s": self.run.window_s / n if n else float("inf")}

    def release(self):
        for mod, name, orig in self._patched:
            setattr(mod, name, orig)
        self._patched.clear()
        self.model = None

    # -- the check -------------------------------------------------------
    def check(self, control: bool = False) -> List[Check]:
        """The compared numbers over the scenes drawn for the check. With
        ``control`` the reference in the next lower precision stands in
        the program's place (float8 network, bfloat16 alignment and
        unprojection)."""
        import torch
        from reference.network import Net
        from reference.precision import fp8, tf32
        from reference.preprocess import load
        from ..weights import make_weights

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
        net, net_lo = Net(w, self.cfg), Net(w, self.cfg, quant=fp8)
        gcfg = self.tr["ga"]
        gaps = {k: 0.0 for k in self.limits}
        shortfall = 0.0
        ga_losses = []
        size = self.cfg["image_size"]
        per_key: Dict[str, float] = {}
        per_rel: Dict[str, float] = {}
        with tf32(False), torch.no_grad():
            for k in chosen:
                out = self.done[k]
                imgs = [torch.as_tensor(load(f, size), device=dev)
                        for f in self.files[k]]
                for (i, j), prog in out["net"]:
                    ref = net.forward(imgs[i][None], imgs[j][None])
                    if control:
                        lo = net_lo.forward(imgs[i][None], imgs[j][None])
                        prog = {f: lo[f][0].cpu().numpy() for f in OUT_KEYS}
                    ref = {f: ref[f][0].cpu().numpy() for f in OUT_KEYS}
                    og = output_gaps(prog, ref)
                    rel = {f: rel_gap(head_space(f, prog[f]),
                                      head_space(f, ref[f]))
                           for f in OUT_KEYS}
                    for f in OUT_KEYS:
                        per_key[f] = worst(per_key.get(f, 0.0), og[f])
                        per_rel[f] = worst(per_rel.get(f, 0.0), rel[f])
                losses = self._ga_losses(out, gcfg, control)
                ga_losses.append(losses)
                l_start, l_ref, l_ans, l_rep, m_ref, m_ans = losses
                gaps["ga_loss_gap"] = worst(
                    gaps["ga_loss_gap"],
                    abs(l_ans - l_rep) / max(abs(l_ans), 1e-30))
                gaps["ga_still"] = worst(gaps["ga_still"],
                                         m_ref / max(m_ans, 1e-30))
                shortfall = max(shortfall, max(0.0, l_ans - l_ref)
                                / max(l_start - l_ref, 1e-12 * abs(l_start)))
                gaps["dense_gap"] = worst(gaps["dense_gap"],
                                          self._dense_gap(out, control))
        del w, net, net_lo
        gaps["net_gap"] = float(np.mean(list(per_key.values())))
        self.run.records["check_details"] = {
            "net_gap_by_output": per_key, "relative_by_output": per_rel,
            "ga_shortfall": shortfall,
            "tf32 ga_loss_gap": getattr(self, "_tf32_gap", None),
            "latencies (min, median, max)": [
                min(self.latencies), float(np.median(self.latencies)),
                max(self.latencies)] if self.latencies else None,
            "ga_losses (start, reference, answer, reported, reference's"
            " move, answer's move)": ga_losses}
        return [Check(k, gaps[k], v) for k, v in self.limits.items()]

    def _ga_losses(self, out, gcfg, control: bool):
        """(L(start), L(reference), L(answer), the loss reported with the
        answer, the reference's `move`, the answer's `move`), every L the
        reference's objective at the last step's annealing; with
        ``control`` the answer and its report come from the reference
        alignment in bfloat16."""
        import torch
        from reference import ga as rga
        from reference.precision import tf32
        data, mst = out["ga_in"]
        d32 = rga.Data(data, mst, self.dev, torch.float32)
        with torch.enable_grad():
            ref = rga.align(d32, gcfg)
            if control:
                with tf32(True):
                    t32 = rga.align(d32, gcfg)
                self._tf32_ga = t32
                lo = rga.align(rga.Data(data, mst, self.dev,
                                        torch.bfloat16), gcfg)
                ans, reported = [x.float() for x in lo[:3]], lo[3]
            else:
                t = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                              device=self.dev)
                ans = [t(out["K"]), t(out["cam2w"]), t(out["core_depth"])]
                reported = out["loss_fine"]
        alpha = 1.0 - (gcfg["niter2"] - 1) / gcfg["niter2"]
        score = lambda a: float(rga.objective(*a, d32, gcfg, alpha))
        with torch.no_grad():
            first = rga.answer(rga.start(d32), d32)
        if control:
            t32 = self._tf32_ga
            self._tf32_gap = max(getattr(self, "_tf32_gap", 0.0),
                                 abs(score(t32[:3]) - t32[3])
                                 / abs(score(t32[:3])))
        m = lambda a: move([x.detach().cpu().numpy() for x in a],
                           [x.cpu().numpy() for x in first])
        return (score(first), score(ref[:3]), score(ans), float(reported),
                m(ref[:3]), m(ans))

    def _dense_gap(self, out, control: bool) -> float:
        """With ``control`` the unprojection in bfloat16 (TF32 reaches none
        of its products, whose inner size is 3)."""
        import torch
        from reference import ga as rga
        from reference.precision import tf32
        dt = torch.bfloat16 if control else torch.float32
        t = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x),
                                                        device=self.dev,
                                                        dtype=dt)
        h, w = out["hw"]
        with tf32(False):
            pts, depths, _ = rga.dense_points(
                t(out["K"], dt), t(out["cam2w"], dt), t(out["core_depth"], dt),
                t(out["anchor_idx"], torch.int64),
                t(out["anchor_offset"], dt), t(out["conf"], dt), h, w)
            pts, depths = pts.float(), depths.float()
        with tf32(False):
            ref, ref_d, _ = rga.dense_points(
                t(out["K"]), t(out["cam2w"]), t(out["core_depth"]),
                t(out["anchor_idx"], torch.int64), t(out["anchor_offset"]),
                t(out["conf"]), h, w)
        got = (pts, depths) if control else (out["pts"], out["depths"])
        gap = 0.0
        for c in range(ref.shape[0]):
            gap = worst(gap, rel_gap(np.asarray(torch.as_tensor(got[0][c])
                                                .cpu()), ref[c].cpu().numpy()),
                        rel_gap(np.asarray(torch.as_tensor(got[1][c]).cpu()),
                                ref_d[c].cpu().numpy()))
        return gap
