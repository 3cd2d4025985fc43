#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`starst3r_tpu_torch`) end to end on one
NVIDIA GPU and hold its CUDA kernels against their plain versions.

    python3 chip_smoke.py [--parent-csrc DIR]

from the root of a checkout, on a machine with one CUDA card, `nvcc` (on the
PATH or under /usr/local/cuda) and PyTorch built for CUDA. It

  1. prints the card's name and power limit (nvidia-smi) and builds every
     CUDA kernel from the sources in the checkout (into
     starst3r_tpu_torch/_build/, one nvcc per source, all started
     together), printing the build seconds and registers;
  2. drives the reconstruct-and-render path at the full MASt3R-large width
     and depth (random weights from seed 0, bfloat16 trunk) on six 224 px
     views made from a numpy seed: Scene.add_images(4 views), then
     add_images(2 more) (warm start and pair cache, GA 500 + 200
     iterations), init_3dgs, render_3dgs_original and an 8-view
     render_3dgs along the path from the first to the last camera, with
     every kernel's launch count set to 0 just before and read just after;
  3. holds the forward compositing kernel against its plain PyTorch version
     on the card, on the entries of the real render and on two small scenes
     (an opaque wall that stops every tile early, a scene with several
     batches per tile), its `done` against the plain early exit
     (`done_plain`), and times both;
  4. drives the training path on the same scene: Scene.run_3dgs_optim for
     TRAIN_STEPS steps with MCMC pruning (refines at steps 100, 150, 200),
     the launch counts set to 0 just before and read just after, then the
     6 original and 8 novel views again;
  5. holds the backward compositing kernel against its plain version (the
     autograd gradient of the plain forward) on the trained scene's entries
     with the real loss's pixel gradients, and on the two small scenes; and
     the entry-gather kernel against ``packed[gidx] * valid``; times each,
     with the gather's library call ``packed[gidx]``;
  6. checks that every output is finite and shaped as expected, that the
     loss fell, that no non-finite gradient came out of the backward kernel
     or the gather's backward and no trained parameter is non-finite, and
     that the pool grew as gsplat's add_new_gs rule says; and times the
     stages of five more training steps (CUDA events that splat.train
     records around its stages) and the kernels of five more
     (torch.profiler);
  7. with --parent-csrc, the compositing kernels of another revision of
     starst3r_tpu_torch/csrc (a parent commit's, unpacked with git
     archive), built with the same nvcc line, held to these and timed
     beside them in turns on the render's and the trained scene's entries.

Each kernel's bound counts the work the run's data needs: for the
compositing kernels the (pixel, entry) pairs inside the entries' cull
boxes, each entry's box, and the pairs that pass the culls
(`bound_ms`); the same over every pair of the batches walked is
`bound_ms_walked`, the figure kernels that walk every pair are held to.

It prints the per-stage seconds, the Gaussian and coverage counts, the
training line, a line `{"kernels": [...]}` and, last,
`{"ok": true, "device": {...}}`. Any failed check exits non-zero before that
last line. Without a CUDA card, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ATOL = 1e-4          # the Pallas forward's own tolerance against its oracle
# the Pallas backward's tolerance: each attribute's gradient over the largest
# magnitude of the plain version's
BWD_SCALED_TOL = 2e-3
HW = 224
N_VIEWS = 6
N_NOVEL = 8
TRAIN_STEPS = 200
REFINE_START, REFINE_EVERY = 100, 50
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 outside the
# tensor cores operations/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# float32 operations per (pixel, entry) pair, counted from the kernels' code
# (csrc/composite_common.cuh, composite_fwd.cu, composite_bwd.cu). Both
# kernels take the falloff and the culls for every pair of the batches they
# walk: offset 2, quadratic form 9, exp and its clip 3, opacity 1, cull 1.
FALLOFF_OPS = 16
# the forward, per pair that passes the culls: clip, weight, 3 colour
# multiply-adds, transmittance
BLEND_OPS = 9
# the backward, per pair that passes the culls: transmittance, colour prefix
# and alpha gradient 20, the 9 gradient terms 24, the per-entry reduction's
# adds 9
BWD_PASS_OPS = 53
# one entry's cull box (csrc/composite_common.cuh::cull_box, for an entry
# whose box is an ellipse's): 37 float operations (determinant 4, log
# threshold 4, two extents 9, centre 4, radii 8, the four bounds 8) and 11
# tests (opacity, 6 finiteness, definiteness 3, threshold). A kernel that
# skips the pairs outside the boxes walks FALLOFF_OPS for the pairs inside
# them and BOX_OPS for every entry walked: the operations both kernels'
# bounds count; the pairs of the whole batches walked give the older,
# larger figure (bound_ms_walked) of kernels that walk every pair
BOX_OPS = 48
# the kernels' warp footprint over a tile (composite_common.cuh), for the
# share of (warp, entry) pairs the per-warp masks skip
WARP_W, WARP_H = 8, 4


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


def pair_counts(entries, counts, done, tile, tw, th):
    """The work the kernels' bounds are counted from, in the batches the
    forward kernel processed (``done``): the entries walked; the (pixel,
    entry) pairs of those batches ("walked"), those inside the entries'
    cull boxes (`cull_boxes_plain`, "in_boxes") and those whose falloff
    passes the culls (sigma >= 0, alpha > 1/255) by the plain version's
    arithmetic ("passing"); and the (warp, entry) pairs of the walked
    entries, all of them and those whose box meets the warp's footprint
    (the bits the per-warp masks set), and the longest and the mean walk
    of a warp through its tile's entries, beside the most entries a tile
    walks."""
    import torch
    from starst3r_tpu_torch.splat import composite as comp

    c, t, k, _ = entries.shape
    e = entries.reshape(c * t, k, 9)
    walked = torch.clamp(counts.reshape(-1).long(),
                         max=done.long() * comp.BATCH)
    slot = torch.arange(k, device=e.device)
    live = slot[None] < walked[:, None]                       # (CT, K)
    box = comp.cull_boxes_plain(entries, tile, tw, th).reshape(c * t, k, 4)
    box = box.long()
    nonempty = live & (box[..., 0] <= box[..., 1]) & (box[..., 2]
                                                      <= box[..., 3])
    area = ((box[..., 1] - box[..., 0] + 1) * (box[..., 3] - box[..., 2] + 1))
    warps = ((box[..., 1] // WARP_W - box[..., 0] // WARP_W + 1)
             * (box[..., 3] // WARP_H - box[..., 2] // WARP_H + 1))
    warps_x = -(-tile // WARP_W)
    n_warps = warps_x * -(-tile // WARP_H)
    # entries each warp of each tile walks: the longest walk sets a tile's
    # time, the slowest tile the kernel's
    walk = torch.stack([(nonempty & (box[..., 0] < fx + WARP_W)
                         & (box[..., 1] >= fx) & (box[..., 2] < fy + WARP_H)
                         & (box[..., 3] >= fy)).sum(1)
                        for fx, fy in ((q % warps_x * WARP_W,
                                        q // warps_x * WARP_H)
                                       for q in range(n_warps))], 1)
    pix_x, pix_y = comp._tile_pix(tw, th, tile, e.device)
    pix_x, pix_y = pix_x.repeat(c, 1)[:, None], pix_y.repeat(c, 1)[:, None]
    passing = 0
    for s in range(0, int(walked.max()) if walked.numel() else 0,
                   comp.BATCH):
        act = torch.nonzero(walked > s).squeeze(1)
        ch = e[act, s:s + comp.BATCH]                         # (A, b, 9)
        inside = live[act, s:s + comp.BATCH][..., None]
        dx = pix_x[act] - ch[:, :, 0:1]                       # (A, b, P)
        dy = pix_y[act] - ch[:, :, 1:2]
        sigma = (0.5 * (ch[:, :, 2:3] * dx * dx + ch[:, :, 4:5] * dy * dy)
                 + ch[:, :, 3:4] * dx * dy)
        alpha = ch[:, :, 8:9] * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
        passing += int((inside & (sigma >= 0.0)
                        & (alpha > 1.0 / 255.0)).sum())
    n_entries = int(walked.sum())
    return {"entries": n_entries, "walked": n_entries * tile * tile,
            "in_boxes": int((area * nonempty).sum()), "passing": passing,
            "warp_pairs": n_entries * n_warps,
            "warp_pairs_set": int((warps * nonempty).sum()),
            "warp_walk_max": int(walk.max()),
            "warp_walk_mean": float(walk[walked > 0].float().mean()),
            "entries_max": int(walked.max())}


def check_done(name, entries, counts, done, tile, tw, th):
    """The forward kernel's early exit processed the batches the plain
    version's transmittance asks for, tile by tile."""
    from starst3r_tpu_torch.splat import composite as comp
    want, near = comp.done_plain(entries, counts, tile, tw, th)
    differ = (done.long() != want) & ~near
    check(not bool(differ.any()), f"{name}: done differs from the plain "
          f"early exit in {int(differ.sum())} tiles")
    return int(near.sum())


def work(pairs, pass_ops):
    """(operations, operations counted over every pair walked): the bound's
    operations with and without the cull boxes."""
    tail = pass_ops * pairs["passing"]
    return (FALLOFF_OPS * pairs["in_boxes"] + BOX_OPS * pairs["entries"]
            + tail, FALLOFF_OPS * pairs["walked"] + tail)


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
    n_near = check_done(name, entries, counts, done, tile, tw, th)
    cnt = counts.reshape(-1).long()
    out = {"case": name, "max_abs_err": err,
           "batches": int(done.sum()),
           "batches_without_exit": int(((cnt + 127) // 128).sum())}
    if timed:
        c, t = counts.shape
        p = tile * tile
        pairs = pair_counts(entries, counts, done, tile, tw, th)
        out["bytes"] = (pairs["entries"] * 36 + c * t * 4        # reads
                        + c * h * w * 16 + c * t * (p + 1) * 4)  # writes
        out["ops"], out["ops_walked"] = work(pairs, BLEND_OPS)
        out["pairs"] = pairs
        out["ms"] = cuda_ms(lambda: comp.composite_tiles_cuda(
            entries, counts, h, w, tile, tw, th), reps=50)
        out["plain_ms"] = cuda_ms(lambda: comp.composite_tiles_plain(
            entries, counts, h, w, tile, tw, th), reps=5, warmup=1)
    print(f"[kernel] composite_fwd {name}: max|kernel - plain| = {err:.3e} "
          f"({n_over} values above {ATOL}), batches {out['batches']} of "
          f"{out['batches_without_exit']} without the early exit, done as "
          f"the plain early exit's in every tile ({n_near} within rounding "
          "of the threshold)", flush=True)
    check(err <= ATOL, f"{name}: kernel disagrees with the plain version "
          f"({err:.3e} > {ATOL})")
    return out


def check_composite_kernel(stt, scene, dev):
    """composite_fwd on the real render's entries and on the two small
    scenes. Returns the cases and the render's inputs."""
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
    return cases, (ent, counts, h, w, tile, tw, th)


def bound(n_bytes, n_ops):
    """(bound ms, what bounds it): the larger of bytes over the card's
    memory rate and float32 operations over its CUDA-core rate."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def set_launches(value=0):
    """Set every kernel's launch count, and the counts of non-finite
    gradient elements out of the backward kernel and the gather's
    backward, to ``value``."""
    from starst3r_tpu_torch.splat import composite as comp, gather as gat
    comp.composite_tiles_cuda.launches = value
    comp.composite_tiles_bwd_cuda.launches = value
    gat.gather_entries_cuda.launches = value
    comp.CompositeTiles.nonfinite = value
    gat.GatherEntries.nonfinite = value


def read_launches():
    from starst3r_tpu_torch.splat import composite as comp, gather as gat
    return {"composite_fwd": comp.composite_tiles_cuda.launches,
            "composite_bwd": comp.composite_tiles_bwd_cuda.launches,
            "gather_entries": gat.gather_entries_cuda.launches}


def read_nonfinite():
    from starst3r_tpu_torch.splat import composite as comp, gather as gat
    return {"composite_bwd": int(comp.CompositeTiles.nonfinite),
            "gather_backward": int(gat.GatherEntries.nonfinite)}


def drive_training(stt, scene, n_novel):
    """The training path: Scene.run_3dgs_optim with MCMC pruning, then the
    original and novel views again. Returns the losses, the loop's host
    seconds, the launch and non-finite counts of the loop, the launch
    counts of the renders after it, and the renders."""
    import dataclasses
    import torch

    cfg = scene.config
    scene.config = dataclasses.replace(cfg, splat=dataclasses.replace(
        cfg.splat, mcmc_refine_start=REFINE_START,
        mcmc_refine_every=REFINE_EVERY))
    h, w = scene.imgs[0].shape[:2]
    set_launches(0)
    t = time.perf_counter()
    losses = scene.run_3dgs_optim(TRAIN_STEPS, enable_pruning=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    train_launches = read_launches()
    nonfinite = read_nonfinite()
    set_launches(0)
    orig = scene.render_3dgs_original(w, h)
    path = stt.interp_se3_path(scene.c2w[0], scene.c2w[-1], n_novel)
    novel = scene.render_3dgs(torch.linalg.inv(path),
                              np.repeat(scene.intrinsics[:1], n_novel, 0),
                              w, h)
    torch.cuda.synchronize()
    return (losses, secs, train_launches, nonfinite, read_launches(), orig,
            novel)


def profile_train_steps(scene, steps=5):
    """Where a training step's time goes, on the path itself
    (Scene.run_3dgs_optim with pruning, as trained): ``steps`` steps with
    splat.train's stage events on (stream milliseconds per stage, which
    include any wait for the host's launches), then ``steps`` more under
    torch.profiler (the device time of each kernel, summed by name; the
    host time of each stage's ``3dgs/`` range; the loop's wall time).
    Returns ({stage: ms per step}, wall ms, device busy ms, {stage: host ms
    per step}, [(kernel name, ms), ...]); busy is 0 when the trace holds
    no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from starst3r_tpu_torch.splat import train as tr

    stages = {}
    tr.stage_events = []
    try:
        scene.run_3dgs_optim(steps, enable_pruning=True)
        torch.cuda.synchronize()
        for name, start, end in tr.stage_events:
            stages[name] = (stages.get(name, 0.0)
                            + start.elapsed_time(end) / steps)
    finally:
        tr.stage_events = None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        scene.run_3dgs_optim(steps, enable_pruning=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels, host = [], {}
    for ev in prof.key_averages():
        on_card = str(ev.device_type).endswith("CUDA")
        if ev.key.startswith("3dgs/"):
            if not on_card:
                host[ev.key[len("3dgs/"):]] = ev.cpu_time_total / 1e3 / steps
        elif on_card:
            kernels.append((ev.key, getattr(ev, "self_device_time_total",
                                            0.0) / 1e3))
    kernels.sort(key=lambda kv: -kv[1])
    return (stages, wall * 1e3, sum(ms for _, ms in kernels), host,
            kernels)


def bwd_case(name, entries, counts, h, w, tile, tw, th, g_rgb, g_alpha,
             timed):
    """composite_bwd against composite_tiles_bwd_plain on one input, on
    the forward kernel's outputs. Returns the scaled error and, when
    ``timed``, the two times and the work the data needs."""
    import torch
    from starst3r_tpu_torch.splat import composite as comp

    rgb, _, tfin, done = comp.composite_tiles_cuda(entries, counts, h, w,
                                                   tile, tw, th)
    got = comp.composite_tiles_bwd_cuda(entries, counts, rgb, tfin, done,
                                        g_rgb, g_alpha, h, w, tile, tw, th)
    torch.cuda.synchronize()
    want = comp.composite_tiles_bwd_plain(entries, counts, done, g_rgb,
                                          g_alpha, h, w, tile, tw, th)
    check(bool(torch.isfinite(got).all()), f"{name}: gradient not finite")
    check_done(name, entries, counts, done, tile, tw, th)
    errs = []
    for a in range(9):
        scale = max(float(want[..., a].abs().max()), 1e-12)
        errs.append(float((got[..., a] - want[..., a]).abs().max()) / scale)
    err = max(errs)
    out = {"case": name, "scaled_err": err,
           "max_abs_err": float((got - want).abs().max())}
    if timed:
        c, t = counts.shape
        p = tile * tile
        pairs = pair_counts(entries, counts, done, tile, tw, th)
        n_walked = pairs["entries"]
        # reads: the entries walked, counts and done, T_fin, rgb and the
        # two pixel gradients; writes: the walked entries' gradients (the
        # rest of the output is the caller's zeros)
        out["bytes"] = (n_walked * 36 + c * t * 8 + c * t * p * 4
                        + c * h * w * (12 + 12 + 4) + n_walked * 36)
        out["ops"], out["ops_walked"] = work(pairs, BWD_PASS_OPS)
        out["pairs"] = pairs
        out["ms"] = cuda_ms(lambda: comp.composite_tiles_bwd_cuda(
            entries, counts, rgb, tfin, done, g_rgb, g_alpha, h, w, tile,
            tw, th), reps=20)
        out["plain_ms"] = cuda_ms(lambda: comp.composite_tiles_bwd_plain(
            entries, counts, done, g_rgb, g_alpha, h, w, tile, tw, th),
            reps=3, warmup=1)
    print(f"[kernel] composite_bwd {name}: max scaled |kernel - plain| = "
          f"{err:.3e} (per attribute {[f'{e:.1e}' for e in errs]}), max "
          f"abs {out['max_abs_err']:.3e}", flush=True)
    check(err <= BWD_SCALED_TOL, f"{name}: backward kernel disagrees with "
          f"the plain version ({err:.3e} > {BWD_SCALED_TOL})")
    return out


def trained_inputs(scene, dev):
    """The trained scene at the tile budgets training picks: the gather's
    table and bins, and the real loss's pixel gradients of its render."""
    import torch
    from starst3r_tpu_torch.ops.ssim import ssim_per_image
    from starst3r_tpu_torch.splat import composite as comp
    from starst3r_tpu_torch.splat import gather as gat
    from starst3r_tpu_torch.splat import train as tr
    from starst3r_tpu_torch.splat.rasterize import (pack_attributes,
                                                    project_gaussians)

    cfg = scene.config.splat
    state = scene.gs_state
    h, w = scene.imgs[0].shape[:2]
    w2c = torch.as_tensor(scene.w2c, dtype=torch.float32, device=dev)
    Ks = torch.as_tensor(scene.intrinsics, dtype=torch.float32, device=dev)
    scfg = tr._autobudget_cfg(state, w2c, Ks, w, h, cfg)
    bins = tr.compute_bins(state.params, w2c, Ks, w, h, scfg,
                           n_alive=state.n_alive)
    proj = project_gaussians(*tr.render_inputs(state.params, scfg,
                                               state.n_alive), w2c, Ks,
                             scfg.sh_degree)
    packed = pack_attributes(proj)
    entries = gat.gather_entries_plain(packed, bins.gidx, bins.ent_valid)
    tile = scfg.tile_size
    tw, th = -(-w // tile), -(-h // tile)
    rgb, alpha, _, _ = comp.composite_tiles_cuda(entries, bins.counts, h, w,
                                                 tile, tw, th)
    gt = torch.as_tensor(np.stack(scene.imgs), dtype=torch.float32,
                         device=dev)
    x = rgb.detach().requires_grad_(True)
    f = cfg.loss_ssim_fac
    loss = torch.sum(torch.mean(torch.abs(gt - x), dim=(1, 2, 3)) * (1 - f)
                     + (1.0 - ssim_per_image(gt, x)) * f)
    (g_rgb,) = torch.autograd.grad(loss, x)
    return dict(scfg=scfg, bins=bins, packed=packed, entries=entries,
                h=h, w=w, tile=tile, tw=tw, th=th,
                g_rgb=g_rgb.contiguous(), g_alpha=torch.zeros_like(alpha))


def check_bwd_kernel(real, dev):
    """composite_bwd on the trained scene and the two small scenes."""
    import torch
    from starst3r_tpu_torch.splat.rasterize import tile_entries

    cases = [bwd_case("trained", real["entries"], real["bins"].counts,
                      real["h"], real["w"], real["tile"], real["tw"],
                      real["th"], real["g_rgb"], real["g_alpha"],
                      timed=True)]
    gen = torch.Generator(device=dev).manual_seed(0)
    for kind in ("wall", "multi"):
        args, kw = small_scene(kind)
        t_args = [torch.as_tensor(a, device=dev) for a in args]
        ent_s, cnt_s, _ = tile_entries(
            *t_args, kw["width"], kw["height"], 1, 16,
            kw["max_tiles_per_gaussian"], kw["max_per_tile"])
        c = cnt_s.shape[0]
        g_rgb = torch.randn((c, kw["height"], kw["width"], 3),
                            generator=gen, device=dev)
        g_alpha = torch.randn((c, kw["height"], kw["width"]), generator=gen,
                              device=dev)
        cases.append(bwd_case(kind, ent_s, cnt_s, kw["height"], kw["width"],
                              16, 2, 2, g_rgb, g_alpha, timed=False))
    return cases


def check_gather_kernel(real):
    """gather_entries against packed[gidx] * valid on the trained scene;
    times it, the plain version and the library's packed[gidx]."""
    import torch
    from starst3r_tpu_torch.splat import gather as gat

    packed, gidx, valid = (real["packed"], real["bins"].gidx,
                           real["bins"].ent_valid)
    got = gat.gather_entries_cuda(packed, gidx, valid)
    torch.cuda.synchronize()
    want = gat.gather_entries_plain(packed, gidx, valid)
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"gather_entries differs from indexing "
          f"(max {err:.3e})")
    n_rows = int(torch.unique(gidx[valid]).numel())
    out = {"max_abs_err": err,
           "bytes": n_rows * 36 + gidx.numel() * (4 + 1) + got.numel() * 4,
           "ops": 0,
           "ms": cuda_ms(lambda: gat.gather_entries_cuda(packed, gidx,
                                                         valid), reps=50),
           "plain_ms": cuda_ms(lambda: gat.gather_entries_plain(
               packed, gidx, valid), reps=20),
           "library_ms": cuda_ms(lambda: packed[gidx], reps=20)}
    print(f"[kernel] gather_entries on the trained scene: {tuple(gidx.shape)}"
          f" slots, {int(valid.sum())} valid, {n_rows} distinct rows; "
          f"max|kernel - plain| = {err}", flush=True)
    return out


SIDE_BY_SIDE = ("composite_fwd", "composite_bwd")


def raw_fwd(fn, ent, counts, h, w, tile, tw, th):
    """A launcher of forward kernel ``fn`` (a ctypes function of the
    composite_fwd C signature) with outputs allocated once: (launch,
    outputs)."""
    import torch
    c, t, k, _ = ent.shape
    dev = ent.device
    out = (torch.empty((c, h, w, 3), device=dev),
           torch.empty((c, h, w), device=dev),
           torch.empty((c * t, tile * tile), device=dev),
           torch.empty((c * t,), dtype=torch.int32, device=dev))

    def launch():
        err = fn(ent.data_ptr(), counts.data_ptr(),
                 *(o.data_ptr() for o in out), c * t, k, tile, tw, th, h, w,
                 torch.cuda.current_stream(dev).cuda_stream)
        check(err == 0, f"launch failed: CUDA error {err}")
    return launch, out


def raw_bwd(fn, ent, counts, fwd_out, g_rgb, g_alpha, h, w, tile, tw, th):
    """A launcher of backward kernel ``fn`` on a forward's outputs, with the
    zero-filled gradient allocated once: (launch, gradient)."""
    import torch
    c, t, k, _ = ent.shape
    rgb, _, tfin, done = fwd_out
    grad = torch.zeros_like(ent)

    def launch():
        err = fn(ent.data_ptr(), counts.data_ptr(), done.data_ptr(),
                 rgb.data_ptr(), tfin.data_ptr(), g_rgb.data_ptr(),
                 g_alpha.data_ptr(), grad.data_ptr(), c * t, k, tile, tw, th,
                 h, w, torch.cuda.current_stream(ent.device).cuda_stream)
        check(err == 0, f"launch failed: CUDA error {err}")
    return launch, grad


def side_by_side(parent_csrc, render_in, real):
    """The parent's compositing kernels (built from ``parent_csrc``) and
    these, on the same inputs in one process: K1 on the render's entries
    and on the trained scene's, K2 on the trained scene's with the real
    loss's pixel gradients. The forward's done must be equal and its rgb,
    alpha and T_fin within ATOL (the same per-pixel arithmetic, only culled
    pairs skipped: expect 0); the backward's within BWD_SCALED_TOL of the
    parent's per attribute (another summation order across the warps).
    Times in turns parent, new, new, parent, launch against launch (no
    allocation in the timed loop)."""
    import torch
    from starst3r_tpu_torch.splat import kernels

    fns = {"parent": {n: getattr(kernels.library(n, parent_csrc), n)
                      for n in SIDE_BY_SIDE},
           "new": {n: getattr(kernels.library(n), n) for n in SIDE_BY_SIDE}}
    trained = (real["entries"], real["bins"].counts, real["h"], real["w"],
               real["tile"], real["tw"], real["th"])
    for case, args in (("render", render_in), ("trained", trained)):
        launchers = {side: raw_fwd(f["composite_fwd"], *args)
                     for side, f in fns.items()}
        for launch, _ in launchers.values():
            launch()
        torch.cuda.synchronize()
        pairs = list(zip(launchers["parent"][1], launchers["new"][1]))
        check(torch.equal(*pairs[3]), f"side by side, K1 {case}: done "
              "differs from the parent kernel's")
        diff = max(float((a - b).abs().max()) for a, b in pairs[:3])
        check(diff <= ATOL, f"side by side, K1 {case}: the new kernel's "
              f"output differs from the parent's by {diff:.3e}")
        ms = {side: [] for side in fns}
        for side in ("parent", "new", "new", "parent"):
            ms[side].append(cuda_ms(launchers[side][0], reps=50))
        print(f"[side-by-side] composite_fwd {case}: parent "
              f"{np.mean(ms['parent']):.4f} ms {ms['parent']}, new "
              f"{np.mean(ms['new']):.4f} ms {ms['new']}; done equal, "
              f"max |new - parent| of rgb, alpha and T_fin {diff:.3e}",
              flush=True)
        if case != "trained":
            continue
        fwd_out = launchers["new"][1]
        bwd = {side: raw_bwd(f["composite_bwd"], *args[:2], fwd_out,
                             real["g_rgb"], real["g_alpha"], *args[2:])
               for side, f in fns.items()}
        for launch, _ in bwd.values():
            launch()
        torch.cuda.synchronize()
        want, got = bwd["parent"][1], bwd["new"][1]
        check(bool(torch.isfinite(got).all()), "side by side, K2: the new "
              "kernel's gradient is not finite")
        errs = [float((got[..., a] - want[..., a]).abs().max())
                / max(float(want[..., a].abs().max()), 1e-12)
                for a in range(9)]
        check(max(errs) <= BWD_SCALED_TOL, "side by side, K2: the new "
              f"kernel disagrees with the parent's ({max(errs):.3e})")
        ms = {side: [] for side in fns}
        for side in ("parent", "new", "new", "parent"):
            ms[side].append(cuda_ms(bwd[side][0], reps=50))
        print(f"[side-by-side] composite_bwd {case}: parent "
              f"{np.mean(ms['parent']):.4f} ms {ms['parent']}, new "
              f"{np.mean(ms['new']):.4f} ms {ms['new']}; max scaled "
              f"|new - parent| {max(errs):.3e}", flush=True)


def main():
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--parent-csrc", default=None,
        help="a directory holding another revision of starst3r_tpu_torch/"
        "csrc (the parent commit's): its compositing kernels are built "
        "with the same nvcc line, held to these and timed beside them on "
        "the render's and the trained scene's entries")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's entry points run on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import starst3r_tpu_torch as stt
    from starst3r_tpu_torch.splat import kernels
    from starst3r_tpu_torch.splat.mcmc import grow_target
    from starst3r_tpu_torch.splat.train import mcmc_config_from

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t = time.perf_counter()
    built = kernels.build()
    if args.parent_csrc:
        built.update({f"parent {n}": v for n, v in kernels.build(
            SIDE_BY_SIDE, csrc=args.parent_csrc).items()})
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t:.2f} s "
          "(one nvcc each, in parallel)", flush=True)
    for name, (secs, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[build] {name}.cu {secs:.2f} s: {' | '.join(regs)}",
              flush=True)

    views = make_views(N_VIEWS, HW)
    t = time.perf_counter()
    model = stt.Mast3rModel.init_random(stt.ModelConfig.large(), seed=0,
                                        device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.net.parameters())
    print(f"[model] ModelConfig.large(): {n_params} parameters, dtype "
          f"{model.cfg.dtype}, init {time.perf_counter() - t:.2f} s",
          flush=True)

    # slice 1: reconstruct and render
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as cache_dir:
        set_launches(0)
        scene, orig, novel, secs = drive_main_path(stt, model, views, dev,
                                                   N_NOVEL, cache_dir)
        render_launches = read_launches()
    del model
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
    print(f"[launches] during the renders: {render_launches}", flush=True)
    check(render_launches["composite_fwd"] > 0
          and render_launches["gather_entries"] > 0,
          "the renders did not launch the forward and gather kernels")
    check_outputs(scene, orig, novel, N_VIEWS, HW, N_NOVEL)
    print(f"[ga] second add_images: coarse / fine phase loss "
          f"{scene.reconstruction.losses}", flush=True)
    fwd_cases, render_in = check_composite_kernel(stt, scene, dev)

    # slice 2: training on the same scene
    n0 = scene.gs_state.n_alive
    pool = scene.gs_state.params["means"].shape[0]
    (losses, train_s, train_launches, nonfinite, after_launches, orig_t,
     novel_t) = drive_training(stt, scene, N_NOVEL)
    n1 = scene.gs_state.n_alive
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    params_bad = {k: int((~torch.isfinite(v)).sum())
                  for k, v in scene.gs_state.params.items()}
    print(f"[train] {TRAIN_STEPS} steps in {train_s:.3f} s: "
          f"{1e3 * train_s / TRAIN_STEPS:.3f} ms/step (host clock, one "
          f"synchronise at the end); loss first {losses[0]:.6f} last "
          f"{losses[-1]:.6f}, mean of the first 20 {first:.6f}, of the last "
          f"20 {last:.6f}; n_alive {n0} -> {n1} (pool {pool}); non-finite "
          f"elements out of the backward kernels {nonfinite}, in the "
          f"trained parameters {params_bad}", flush=True)
    print(f"[launches] during run_3dgs_optim: {train_launches}; during the "
          f"renders after it: {after_launches}", flush=True)
    check(all(np.isfinite(losses)) and len(losses) == TRAIN_STEPS,
          "a training loss is not finite")
    check(sum(params_bad.values()) == 0,
          f"non-finite trained parameters: {params_bad}")
    for name, count in nonfinite.items():
        check(count == 0, f"{name} gave {count} non-finite gradient elements "
              "during run_3dgs_optim")
    check(last < first, f"the loss did not fall ({first} -> {last})")
    mcfg = mcmc_config_from(scene.config.splat)
    want = n0
    for step in range(REFINE_START, TRAIN_STEPS + 1, REFINE_EVERY):
        want = grow_target(want, pool, mcfg)
    check(n1 == want, f"n_alive {n1} after training, grow_target gives "
          f"{want}")
    for name, count in train_launches.items():
        check(count > 0, f"training did not launch {name}")
    check_outputs(scene, orig_t, novel_t, N_VIEWS, HW, N_NOVEL)
    print(f"[render] after training, mean alpha: original views "
          f"{float(orig_t[1].mean()):.4f}, novel views "
          f"{float(novel_t[1].mean()):.4f}", flush=True)

    stages, wall_ms, busy_ms, host, by_kernel = profile_train_steps(scene)
    print("[train-stages] stream ms per step (CUDA events in "
          "splat.train): " + " ".join(f"{k}={v:.3f}"
                                      for k, v in stages.items())
          + f" total={sum(stages.values()):.3f}", flush=True)
    print(f"[profile] 5 training steps under torch.profiler: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms"
          + (f" ({100 * busy_ms / wall_ms:.1f}%)" if busy_ms else
             " (no device events in the trace: not measured)")
          + "; host ms per step by stage: " + " ".join(
              f"{k}={v:.3f}" for k, v in host.items()), flush=True)
    for name, ms in by_kernel[:10]:
        print(f"[profile]   {ms / 5:9.3f} ms/step  {name[:90]}", flush=True)

    real = trained_inputs(scene, dev)
    print(f"[budget] training's tile budgets: max_tiles_per_gaussian "
          f"{real['scfg'].max_tiles_per_gaussian}, max_per_tile "
          f"{real['scfg'].max_per_tile}", flush=True)
    bwd_cases = check_bwd_kernel(real, dev)
    gather = check_gather_kernel(real)
    if args.parent_csrc:
        side_by_side(args.parent_csrc, render_in, real)

    kernels_line = []
    # composite_bwd's error is the scaled one its tolerance is stated in:
    # per attribute, max |kernel - plain| over the plain version's largest
    # magnitude (the conic gradients of the trained scene reach 1e11)
    rows = (("composite_fwd", "starst3r_tpu/splat/pallas_composite.py:107",
             fwd_cases[0], max(c["max_abs_err"] for c in fwd_cases), None),
            ("composite_bwd", "starst3r_tpu/splat/pallas_composite.py:159",
             bwd_cases[0], max(c["scaled_err"] for c in bwd_cases), None),
            ("gather_entries", "tools/probe_mosaic_gather.py:69", gather,
             gather["max_abs_err"], gather["library_ms"]))
    for name, replaces, case, err, library_ms in rows:
        bound_ms, bound_by = bound(case["bytes"], case["ops"])
        walked_ms, _ = bound(case["bytes"], case.get("ops_walked", 0))
        pairs = case.get("pairs", {})
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": f"starst3r_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": train_launches[name],
            "max_abs_err": err, "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "bound_ms_walked": walked_ms,
            "pairs_walked": pairs.get("walked"),
            "pairs_in_boxes": pairs.get("in_boxes"),
            "pairs_passing": pairs.get("passing")})
        print(f"[kernel] {name}: {case['ms']:.4f} ms, plain "
              f"{case['plain_ms']:.4f} ms, library "
              f"{library_ms if library_ms is None else round(library_ms, 4)}"
              f" ms, bound {bound_ms:.4f} ms ({bound_by}: {case['bytes']} B,"
              f" {case['ops']} ops), bound over every pair walked "
              f"{walked_ms:.4f} ms ({case.get('ops_walked', 0)} ops); work "
              f"{pairs or None}", flush=True)
        if pairs:
            print(f"[masks] {name}: the per-warp masks set "
                  f"{pairs['warp_pairs_set']} of {pairs['warp_pairs']} "
                  f"(warp, entry) pairs, skip "
                  f"{1 - pairs['warp_pairs_set'] / pairs['warp_pairs']:.4f};"
                  f" the boxes hold {pairs['in_boxes']} of "
                  f"{pairs['walked']} (pixel, entry) pairs, "
                  f"{pairs['passing']} pass the culls; a warp walks "
                  f"{pairs['warp_walk_mean']:.1f} entries on average, the "
                  f"longest walk {pairs['warp_walk_max']} (the most entries "
                  f"a tile walks: {pairs['entries_max']})", flush=True)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
