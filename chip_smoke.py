#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`starst3r_tpu_torch`) end to end on one
NVIDIA GPU and hold its CUDA kernel against the kernel's plain version.

    python3 chip_smoke.py

from the root of a checkout, on a machine with one CUDA card, `nvcc` (on the
PATH or under /usr/local/cuda) and PyTorch built for CUDA. It

  1. prints the card's name and power limit (nvidia-smi) and builds every
     CUDA kernel from the sources in the checkout (into
     starst3r_tpu_torch/_build/), printing the build seconds;
  2. drives the reconstruct-and-render path at the full MASt3R-large width
     and depth (random weights from seed 0, bfloat16 trunk) on six 224 px
     views made from a numpy seed: Scene.add_images(4 views), then
     add_images(2 more) (warm start and pair cache, GA 500 + 200
     iterations), init_3dgs, render_3dgs_original and an 8-view
     render_3dgs along the path from the first to the last camera, with
     every kernel's launch count set to 0 just before and read just after;
  3. holds each kernel against its plain PyTorch version on the card, on
     the entries of the real render and on two small scenes (an opaque wall
     that stops every tile early, a scene with several batches per tile),
     and times both;
  4. checks that every output is finite and shaped as expected.

It prints the per-stage seconds, the Gaussian and coverage counts, a line
`{"kernels": [...]}` and, last, `{"ok": true, "device": {...}}`. Any failed
check exits non-zero before that last line. Without a CUDA card, or outside
a checkout of the repository, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ATOL = 1e-4          # the Pallas forward's own tolerance against its oracle
HW = 224
N_VIEWS = 6
N_NOVEL = 8
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the
# tensor cores operations/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# float32 operations per (pixel, entry) pair the compositing loop visits:
# offset 2, quadratic form 9, exp 1, opacity 1, cull/clip 3, blend 9
OPS_PER_PAIR = 25


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def make_views(n, hw, seed=0):
    """n views of a coloured 3D point grid seen from a camera that turns
    about the vertical axis (examples/demo.py's synthetic scene), as the
    port's processed (3, H, W) images in [-1, 1]."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, size=(4000, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    cols = rng.uniform(0.2, 1.0, size=(4000, 3)).astype(np.float32)
    views = []
    for k in range(n):
        ang = 0.06 * (k - n / 2)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        p = pts @ R.T
        img = np.full((hw, hw, 3), 0.12, np.float32)
        f = hw * 0.8
        u = (f * p[:, 0] / p[:, 2] + hw / 2).astype(int)
        v = (f * p[:, 1] / p[:, 2] + hw / 2).astype(int)
        ok = (u >= 1) & (u < hw - 1) & (v >= 1) & (v < hw - 1)
        far_first = np.argsort(-p[:, 2])
        ok = ok[far_first]
        uu, vv, cc = u[far_first][ok], v[far_first][ok], cols[far_first][ok]
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                img[vv + dv, uu + du] = cc
        views.append(np.ascontiguousarray(
            (img * 2.0 - 1.0).transpose(2, 0, 1)))
    return views


def drive_main_path(stt, model, views, device, n_novel, cache_dir):
    """The serving half of the README Quickstart. Returns the scene, the
    renders and the host seconds per stage."""
    import torch
    from starst3r_tpu_torch.utils.metrics import MetricsLogger

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    logger = MetricsLogger()
    scene = stt.Scene(cache_dir=cache_dir, device=device, logger=logger)
    secs = {}
    t = time.perf_counter()
    # random weights' confidences carry no information: keep every pixel
    # that survives the cross-view cleaning (conf 1 marks the rejected),
    # so the renders see a point cloud of full size
    scene.add_images(model, views[:4], conf_thres=1.0)
    scene.add_images(model, views[4:], conf_thres=1.0)
    secs["add_images"] = time.perf_counter() - t
    for rec in logger.records:
        for stage in ("inference", "matching", "canonical", "condense", "ga"):
            secs[stage] = secs.get(stage, 0.0) + rec[stage]
    t = time.perf_counter()
    scene.init_3dgs()
    sync()
    secs["init_3dgs"] = time.perf_counter() - t
    h, w = scene.imgs[0].shape[:2]
    t = time.perf_counter()
    rgb, alpha, info = scene.render_3dgs_original(w, h)
    sync()
    secs["render_original"] = time.perf_counter() - t
    path = stt.interp_se3_path(scene.c2w[0], scene.c2w[-1], n_novel)
    w2c = torch.linalg.inv(path)
    Ks = np.repeat(scene.intrinsics[:1], n_novel, 0)
    t = time.perf_counter()
    rgb_n, alpha_n, info_n = scene.render_3dgs(w2c, Ks, w, h)
    sync()
    secs["render_novel"] = time.perf_counter() - t
    return scene, (rgb, alpha, info), (rgb_n, alpha_n, info_n), secs


def check_outputs(scene, orig, novel, n_views, hw, n_novel):
    import torch
    c2w = np.asarray(scene.c2w)
    check(c2w.shape == (n_views, 4, 4) and np.isfinite(c2w).all(),
          f"cam2w {c2w.shape} not finite")
    rot = c2w[:, :3, :3]
    check(np.allclose(rot @ rot.transpose(0, 2, 1), np.eye(3), atol=1e-3),
          "cam2w rotations are not orthonormal")
    check(np.isfinite(scene.intrinsics).all(), "intrinsics not finite")
    pts = scene.dense_pts_flat
    check(pts.shape[0] > 0 and np.isfinite(pts).all(),
          f"dense points: {pts.shape[0]}, finite {np.isfinite(pts).all()}")
    for (rgb, alpha, _), n in ((orig, n_views), (novel, n_novel)):
        check(tuple(rgb.shape) == (n, hw, hw, 3), f"rgb {tuple(rgb.shape)}")
        check(tuple(alpha.shape) == (n, hw, hw, 1),
              f"alpha {tuple(alpha.shape)}")
        check(bool(torch.isfinite(rgb).all() & torch.isfinite(alpha).all()),
              "render not finite")
        check(float(alpha.min()) >= 0.0 and float(alpha.max()) <= 1.0,
              "alpha outside [0, 1]")
        check(float(alpha.amax()) > 0.5, "render is empty")


def small_scene(kind, seed=0):
    """The two small scenes of tests/test_torch_cuda.py the kernel is
    held on: 'wall' (near-opaque wide Gaussians stacked in depth, which
    saturates every tile in its first batch) and 'multi' (1400 Gaussians,
    several 128-entry batches per tile). Returns rasterize's arguments and
    keywords."""
    rng = np.random.default_rng(seed)
    if kind == "wall":
        n = 600
        means = np.zeros((n, 3), np.float32)
        means[:, 2] = np.linspace(1.0, 5.0, n)
        means[:, :2] = rng.normal(size=(n, 2)) * 0.01
        quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
        scales = np.full((n, 3), 2.0, np.float32)
        opac = np.full((n,), 0.999, np.float32)
        sh = np.zeros((n, 4, 3), np.float32)
        sh[:, 0] = rng.normal(size=(n, 3))
        w2c = np.eye(4, dtype=np.float32)[None]
        kw = dict(max_tiles_per_gaussian=9, max_per_tile=1024)
    else:
        n = 1400
        means = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
        means[:, 2] += 2.5
        quats = rng.normal(size=(n, 4)).astype(np.float32)
        quats /= np.linalg.norm(quats, axis=1, keepdims=True)
        scales = rng.uniform(0.01, 0.08, size=(n, 3)).astype(np.float32)
        opac = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
        sh = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.3
        w2c = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
        w2c[1, 0, 3] = 0.15
        kw = dict(max_tiles_per_gaussian=4, max_per_tile=512)
    K = np.tile(np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]],
                         np.float32)[None], (w2c.shape[0], 1, 1))
    return (means, quats, scales, opac, sh, w2c, K), dict(kw, width=32,
                                                         height=32)


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def composite_case(name, entries, counts, h, w, tile, tw, th, timed):
    """Kernel against the plain version on one input. Returns the errors
    and, when ``timed``, the two times and the work the data needs."""
    import torch
    from starst3r_tpu_torch.splat import composite as comp

    rgb_k, a_k, tfin, done = comp.composite_tiles_cuda(entries, counts, h,
                                                       w, tile, tw, th)
    torch.cuda.synchronize()
    rgb_p, a_p = comp.composite_tiles_plain(entries, counts, h, w, tile, tw,
                                            th)
    d_rgb = (rgb_k - rgb_p).abs()
    d_a = (a_k - a_p).abs()
    err = max(float(d_rgb.max()), float(d_a.max()))
    n_over = int((d_rgb > ATOL).sum()) + int((d_a > ATOL).sum())
    check(bool(torch.isfinite(rgb_k).all() & torch.isfinite(tfin).all()),
          f"{name}: kernel output not finite")
    cnt = counts.reshape(-1).long()
    needed = torch.clamp(cnt, max=done.long() * 128)
    out = {"case": name, "max_abs_err": err,
           "batches": int(done.sum()),
           "batches_without_exit": int(((cnt + 127) // 128).sum())}
    if timed:
        c, t = counts.shape
        p = tile * tile
        n_entries = int(needed.sum())
        out["bytes"] = (n_entries * 36 + c * t * 4          # reads
                        + c * h * w * 16 + c * t * (p + 1) * 4)  # writes
        out["ops"] = OPS_PER_PAIR * p * n_entries
        out["ms"] = cuda_ms(lambda: comp.composite_tiles_cuda(
            entries, counts, h, w, tile, tw, th), reps=50)
        out["plain_ms"] = cuda_ms(lambda: comp.composite_tiles_plain(
            entries, counts, h, w, tile, tw, th), reps=5, warmup=1)
    print(f"[kernel] composite_fwd {name}: max|kernel - plain| = {err:.3e} "
          f"({n_over} values above {ATOL}), batches {out['batches']} of "
          f"{out['batches_without_exit']} without the early exit",
          flush=True)
    check(err <= ATOL, f"{name}: kernel disagrees with the plain version "
          f"({err:.3e} > {ATOL})")
    return out


def check_composite_kernel(stt, scene, dev):
    """composite_fwd on the real render's entries and on the two small
    scenes."""
    import torch
    from starst3r_tpu_torch.splat.rasterize import tile_entries
    from starst3r_tpu_torch.splat.train import render_inputs

    cfg = scene.config.splat
    h, w = scene.imgs[0].shape[:2]
    tile = cfg.tile_size
    tw, th = -(-w // tile), -(-h // tile)
    gauss = render_inputs(scene.gs_state.params, cfg, scene.gs_state.n_alive)
    w2c = torch.as_tensor(scene.w2c, dtype=torch.float32, device=dev)
    Ks = torch.as_tensor(scene.intrinsics, dtype=torch.float32, device=dev)
    ent, counts, _ = tile_entries(*gauss, w2c, Ks, w, h, cfg.sh_degree, tile,
                                  cfg.max_tiles_per_gaussian,
                                  cfg.max_per_tile)
    cases = [composite_case("render", ent, counts, h, w, tile, tw, th,
                            timed=True)]
    for kind in ("wall", "multi"):
        args, kw = small_scene(kind)
        t_args = [torch.as_tensor(a, device=dev) for a in args]
        ent_s, cnt_s, _ = tile_entries(
            *t_args, kw["width"], kw["height"], 1, 16,
            kw["max_tiles_per_gaussian"], kw["max_per_tile"])
        case = composite_case(kind, ent_s, cnt_s, kw["height"], kw["width"],
                              16, 2, 2, timed=False)
        if kind == "wall":
            check(case["batches"] < case["batches_without_exit"],
                  "the opaque wall did not stop early")
        else:
            check(int(cnt_s.max()) > 128, "no tile has several batches")
        cases.append(case)
    return cases


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's entry points run on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import starst3r_tpu_torch as stt
    from starst3r_tpu_torch.splat import composite as comp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t = time.perf_counter()
    log = comp.build_kernel()
    print(f"[build] composite_fwd.cu {time.perf_counter() - t:.2f} s",
          flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    views = make_views(N_VIEWS, HW)
    t = time.perf_counter()
    model = stt.Mast3rModel.init_random(stt.ModelConfig.large(), seed=0,
                                        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.net.parameters())
    print(f"[model] ModelConfig.large(): {n_params} parameters, dtype "
          f"{model.cfg.dtype}, init {time.perf_counter() - t:.2f} s",
          flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as cache_dir:
        comp.composite_tiles_cuda.launches = 0
        scene, orig, novel, secs = drive_main_path(stt, model, views, dev,
                                                   N_NOVEL, cache_dir)
        launches = comp.composite_tiles_cuda.launches
    print("[stages] " + " ".join(f"{k}={v:.3f}s" for k, v in secs.items()),
          flush=True)
    n_gauss = int(scene.gs_state.n_alive)
    print(f"[splat] gaussians {n_gauss} (pool "
          f"{scene.gs_state.params['means'].shape[0]}); original views: "
          f"tile_overflow {orig[2]['tile_overflow'].tolist()} "
          f"n_tiles_clipped {orig[2]['n_tiles_clipped'].tolist()}; novel "
          f"views: tile_overflow {novel[2]['tile_overflow'].tolist()} "
          f"n_tiles_clipped {novel[2]['n_tiles_clipped'].tolist()}",
          flush=True)
    print(f"[render] mean alpha: original views "
          f"{float(orig[1].mean()):.4f}, novel views "
          f"{float(novel[1].mean()):.4f}", flush=True)
    print(f"[launches] composite_fwd {launches} during the renders",
          flush=True)
    check(launches > 0, "the renders did not launch the compositing kernel")
    check_outputs(scene, orig, novel, N_VIEWS, HW, N_NOVEL)
    print(f"[ga] second add_images: coarse / fine phase loss "
          f"{scene.reconstruction.losses}", flush=True)

    cases = check_composite_kernel(stt, scene, dev)
    real = cases[0]
    bound_by = ("bytes" if real["bytes"] / PEAK_BYTES
                >= real["ops"] / PEAK_F32 else "operations")
    bound_ms = max(real["bytes"] / PEAK_BYTES, real["ops"] / PEAK_F32) * 1e3
    kernels = [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "starst3r_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "starst3r_tpu/splat/pallas_composite.py:107",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": real["ms"],
        "plain_ms": real["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(f"[kernel] composite_fwd on the render's entries: {real['ms']:.4f}"
          f" ms, plain {real['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {real['bytes']} B, {real['ops']} ops)", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
