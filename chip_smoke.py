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
  3. holds the forward compositing kernel, on both of its routes (the
     rasterizer's packed route, which gathers each entry's row as it stages
     it, and the entries route on the standalone gather's output), against
     its plain PyTorch version on the card, on the real render's inputs and
     on two small scenes (an opaque wall that stops every tile early, a
     scene with several batches per tile), its `done` against the plain
     early exit (`done_plain`), and times the packed route and the plain
     version;
  4. drives the training path on the same scene: Scene.run_3dgs_optim for
     TRAIN_STEPS steps with MCMC pruning (refines at steps 100, 150, 200),
     the launch counts set to 0 just before and read just after, then the
     6 original and 8 novel views again;
  5. holds the backward compositing kernel on both routes against its
     plain version (the autograd gradient of the plain forward; on the
     packed route ``index_add_``-ed into the projected table) on the
     trained scene with the real loss's pixel gradients, and on the two
     small scenes; and the standalone entry-gather kernel against
     ``packed[gidx] * valid``; times each, with the gather's library call
     ``packed[gidx]``;
  6. checks that every output is finite and shaped as expected, that the
     loss fell, that no non-finite gradient came out of the backward kernel
     or the gather's backward and no trained parameter is non-finite, and
     that the pool grew as gsplat's add_new_gs rule says; and times the
     stages of five more training steps (CUDA events that splat.train
     records around its stages) and the kernels of five more
     (torch.profiler);
  7. `[fused]`: on the render's inputs and the trained scene, the packed
     routes against the unfused chains they replace, in one process, in
     turns (`device_ms` and CUDA events): the gather and the entries-route
     forward against the packed forward (rgb, alpha, T_fin and done equal bit for bit); the
     backward's zero fill, entries route, mask and ``index_add_`` against
     the packed backward and its zeroed table (within 1e-6 per attribute);
     and one training step on each route (the same state and bins): its
     peak device memory and, under torch.profiler, its device-busy time;
  8. with --parent-csrc, the compositing kernels of another revision of
     starst3r_tpu_torch/csrc (a parent commit's, unpacked with git
     archive), built with the same nvcc line, held to these and timed
     beside them in turns on the render's and the trained scene's entries;
  9. `[checkpoint]`: Scene.save of the trained scene and Scene.load on the
     card (every array equal bit for bit), 10 training steps on the loaded
     scene (finite losses); save_pretrained of the large model and
     from_pretrained on the card (every tensor equal bit for bit, one pair
     through both models within tests/test_torch_model.py's tolerances),
     after checking the temporary directory has room for its ~2.75 GB
     (the file stays there for `[cli]`);
 10. `[register]`: Scene.register_camera of a seventh view (only its new
     pairs go through the network, the pair cache holds the rest): the six
     frozen cameras' chain parameters within 1e-6 of before, a finite
     (4, 4) c2w, seven cameras;
 11. `[polish]`: reconstruct_scene on the six views through the pair cache
     with spectral low-rank depth and the LM polish, then with the Schur
     polish: the stage seconds, the polish's cost sequence (never rising,
     the last at most the first), finite poses and focals. The random
     network's match confidences leave the polish's correspondences with
     weight 0 there, so both refiners also run on a planted problem of the
     same size (six cameras, 784 core points each, every pair matched),
     where they must bring the cost below 1e-4 of its first value and the
     poses within 1e-2 of the planted ones;
 12. `[k2-margin]` (printed after step 5's checks): at the entries where the
     backward kernel and its plain version disagree most on the trained
     scene, both against the float64 autograd gradient of the plain
     forward on those entries' tiles, to tell which of the two is off
     (and how many of those entries the float64 forward culls);
 13. `[cli]`: the port's command line, the way its users start it, at full
     width: the six views written as PNG files, then in process
     `reconstruct --preset large --model <[checkpoint]'s model.npz> --res
     224 --incremental-batch 4 --gs-iters 50`, `train-gs --iters 50`,
     `render-path --steps 8` and `export-ply`, with the launch counts set
     to 0 just before and read just after each (the kernels launched
     where a subcommand renders or trains; the images loaded through the
     native C++ route; every output file written; the PLY's points the
     scene's dense points; 8 finite, non-uniform frames); then
     `python -m starst3r_tpu_torch info` (naming the card) and a
     `--trace-dir` reconstruct (GA 30 + 10, 5 training steps) in
     subprocesses (its inference/, ga/ and
     splat_optim/ traces written; their device events reported, not
     checked). The seconds are on a `[stages] cli:` line;
 14. `[planted-ga]`: the GA on the card recovers planted cameras
     (`utils.synthetic`, `utils.eval`; tests/test_ga_groundtruth.py's
     instances and bounds): ATE below 0.12 x the trajectory scale and RPE
     below 8 degrees on the snapped scene, ATE below 0.001 x the scale on
     the snap-free one;
 15. `[turntable]`: examples/turntable_torch.py's recipe at its defaults
     (128 px, 8 cameras, GA 500 + 200, 600 training steps, 48 frames):
     ATE below 0.12 x the scale, the loss falling, the training views'
     PSNR at the recovered poses (printed), the kernels launched, the
     orbit's frames. Steps 13-15's seconds and step 12's errors are on a
     `[stages] slice 6:` line;
 16. `[parallel]` (run after step 8, on the trained six-view scene): the
     sharded paths of `starst3r_tpu_torch/parallel/` against the meshless
     runs. (a) In this process, a world of one over NCCL: pair-parallel
     inference (`infer_pairs(sharding=)`) equal to the meshless
     predictions; `reconstruct_scene(mesh=)` against the meshless call
     (cache off, GA 100 + 50) in camera 0's frame; `run_optim(mesh=)`
     for 50 steps with one MCMC refine, K1 and K2 launched 50 times
     each, its losses against the meshless run's (the first step's to
     1e-6; the rest to 2e-4 or twice the meshless run's distance from
     itself run again, the backward's atomics); the sharded LM and Schur
     polish on the planted problem. (b) Two ranks on the one card over
     gloo, each its own interpreter (`parallel_rank`): the large model's
     tensor-parallel forward (model axis 2) of 8 pairs against the
     meshless bfloat16 forward (at most twice that forward's own distance
     from float32), the same 50 training steps (K1 and K2 launched 50
     times a rank) against (a)'s meshless losses, and the polish. Its
     seconds are on a `[stages] slice 7:` line.

Each kernel's bound counts the work the run's data needs: for the
compositing kernels the (pixel, entry) pairs inside the entries' cull
boxes, each entry's box, and the pairs that pass the culls
(`bound_ms`); the same over every pair of the batches walked is
`bound_ms_walked`, the figure kernels that walk every pair are held to.
The compositing kernels' rows on the `kernels` line are their packed
routes, the ones the main path launches: their bytes count each entry
walked as its 4-byte index and its 36-byte row (and, for the backward,
36 bytes of reduction adds per entry that contributed), and
`bytes_sector` counts each row as the two 32-byte sectors it spans. A
kernel's `ms` (and `library_ms`) is device time per call: CUDA events
around a loop of calls queued behind a spin kernel that holds the stream
until the host has queued them all (`device_ms`), so every kernel the call
launches counts (the backward's includes the zero fill of its output) and
the host's launch pace does not; `ms_events` beside it is the CUDA-event
time per call of the same loop unqueued, which counts the pace too;
`plain_ms` is CUDA-event time. torch.profiler only breaks times down and
sums a training step's device-busy time; where its trace holds no device
time those figures read "not measured" and nothing fails.

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
# the packed routes against the unfused chains: the same per-entry sums,
# added into the table's rows in another order
FUSED_SCALED_TOL = 1e-6
ROW_BYTES, ROW_SECTOR_BYTES, INDEX_BYTES = 36, 64, 4
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
# register_camera: how far a frozen camera's chain parameters may move (the
# per-step quaternion renormalisation's rounding; tests/test_integration.py)
REGISTER_TOL = 1e-6
# a model loaded from its checkpoint against the one saved: one pair's
# outputs within tests/test_torch_model.py's tolerances (and rtol 2e-3)
OUT_ATOL = {"pts1": 5e-4, "pts2": 5e-4, "conf1": 1e-3, "conf2": 1e-3,
            "desc1": 1e-3, "desc2": 1e-3, "desc_conf1": 1e-3,
            "desc_conf2": 1e-3}
# the two polished reconstructions of `[polish]`, at the GA's defaults
# otherwise. The polish weights each correspondence by its confidence
# times its pair's matching flag (best match confidence above
# GAConfig.matching_conf_thr); on the random network's views no pair
# passes, so `planted_polish` gives the refiners a problem of this size
# `[cli]`: the training steps of reconstruct --gs-iters and of train-gs
CLI_STEPS = 50
# the device events of a torch.profiler trace (its kernels, copies and fills)
CUDA_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# `[parallel]`: the reconstruction's GA steps (cut from the main path's
# 500 + 200 to keep the phase short), the sharded training's steps, and
# the tolerances. Losses rtol 2e-4 (tests/test_distributed.py), or twice
# the meshless run's largest distance from itself run twice more where
# that is larger (measured in the same call: the backward's atomics part
# two runs from the second step on, and Adam's normalised steps carry it
# to ~1% of the loss within a few steps on this scene). The polish on the
# planted problem: poses within 1e-3 of the meshless run's, as
# tests/test_lm.py and tests/test_schur.py hold a sharded run, and the
# cost below 1e-4 of its first (planted_polish's bound); the costs are
# printed, not compared: the damped system's condition number (~1e7)
# turns float32 sums in another order into percent-level moves of the
# first steps (ROADMAP.md, constraints). Pair-parallel predictions and
# the GA under a world of one as the meshless ones, to float noise
PAR_GA = (100, 50)
PAR_STEPS = 50
PAR_LOSS_RTOL = 2e-4
PAR_REPEATS = 2
# the first step's loss: the same parameters, a deterministic forward
# (summed over two ranks' cameras in (b))
PAR_FIRST_RTOL = 1e-6
PAR_POSE_ATOL = 1e-3
PAR_CONVERGED = 1e-4
PAR_INFER_TOL = 1e-5
# tensor parallelism sums each row-parallel layer's two halves, rounded to
# the activation dtype, where the meshless layer rounds once: its distance
# from the meshless forward is held to twice the meshless bfloat16
# forward's own distance from its float32 forward (measured in the same
# run), and never below float32 summation-order noise
PAR_TP_FLOOR = 1e-4
PAR_GA_TOL = 1e-3
PAR_TIMEOUT = 600
POLISH = {
    "lora+lm": dict(opt_depth=True, lora_depth=True, refine_lm=True,
                    lm_mode="lm"),
    "schur": dict(refine_lm=True, lm_mode="schur"),
}


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


_SLEEP_CYCLES_PER_MS = []


def sleep_cycles_per_ms():
    """The card's `torch.cuda._sleep` cycles per millisecond, measured once
    with CUDA events over a 2M-cycle spin."""
    import torch
    if not _SLEEP_CYCLES_PER_MS:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)            # warm
        start.record()
        torch.cuda._sleep(2_000_000)
        end.record()
        end.synchronize()
        _SLEEP_CYCLES_PER_MS.append(2_000_000 / start.elapsed_time(end))
    return _SLEEP_CYCLES_PER_MS[0]


def device_ms(fn, reps, warmup=2):
    """Device time per call of ``fn``: CUDA events around ``reps`` calls
    queued behind a spin kernel (`torch.cuda._sleep`) that holds the stream
    until the host has queued them all, so the card runs them back to back
    and the host's launch pace does not count. The spin is lengthened until
    it is still running when the host has queued the last call (an event
    recorded after it has not completed); ``fn`` must not synchronise."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(6):
        torch.cuda._sleep(int((2 * queue_ms + 1.0) * sleep_cycles_per_ms()))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        queue_ms *= 2
    raise CheckFailed(f"device_ms: the host did not queue {reps} calls "
                      "within the spin; the timed function synchronises")


def profiled_ms(fn, reps, tries=2):
    """The device time of every kernel ``fn`` launches (memsets and copies
    included), summed by torch.profiler over ``reps`` calls and divided by
    ``reps``: (ms, {kernel name: ms}), or (None, {}) when the trace holds no
    device time in any of ``tries`` sessions. What it breaks down or sums is
    reported, never checked."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_kernel = {ev.key: getattr(ev, "self_device_time_total", 0.0)
                     / 1e3 / reps for ev in prof.key_averages()
                     if str(ev.device_type).endswith("CUDA")}
        if sum(by_kernel.values()) > 0:
            return sum(by_kernel.values()), by_kernel
    return None, {}


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
    arithmetic ("passing"), and the entries with a passing pixel
    ("contributing": the packed backward's reduction adds); and the (warp,
    entry) pairs of the walked
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
    passing = contributing = 0
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
        hit = inside & (sigma >= 0.0) & (alpha > 1.0 / 255.0)
        passing += int(hit.sum())
        contributing += int(hit.any(-1).sum())
    n_entries = int(walked.sum())
    return {"entries": n_entries, "walked": n_entries * tile * tile,
            "in_boxes": int((area * nonempty).sum()), "passing": passing,
            "contributing": contributing,
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


def case_inputs(packed, gidx, valid, counts, h, w, tile, tw, th):
    """One compositing input in both forms: the projected table and the
    binning's indices (the packed routes), and the entries the gather
    gives (the entries routes and the plain versions)."""
    from starst3r_tpu_torch.splat import gather as gat
    return dict(packed=packed.detach().contiguous(), gidx=gidx,
                valid=valid, counts=counts,
                entries=gat.gather_entries_plain(packed.detach(), gidx,
                                                 valid),
                h=h, w=w, tile=tile, tw=tw, th=th)


def geometry(x):
    return x["h"], x["w"], x["tile"], x["tw"], x["th"]


def run_fwd(x, route):
    """One launch of the forward kernel's route on input ``x``: rgb,
    alpha, tfin, done."""
    from starst3r_tpu_torch.splat import composite as comp
    if route == "packed":
        return comp.composite_packed_cuda(x["packed"], x["gidx"], x["counts"],
                                          *geometry(x))
    return comp.composite_tiles_cuda(x["entries"], x["counts"], *geometry(x))


def composite_case(name, x, route, timed):
    """A forward route against the plain version on one input. Returns
    the errors and, when ``timed``, the two times and the work the data
    needs."""
    import torch
    from starst3r_tpu_torch.splat import composite as comp
    from starst3r_tpu_torch.splat import gather as gat

    entries, counts = x["entries"], x["counts"]
    h, w, tile, tw, th = geometry(x)
    rgb_k, a_k, tfin, done = run_fwd(x, route)
    torch.cuda.synchronize()
    rgb_p, a_p = comp.composite_tiles_plain(entries, counts, *geometry(x))
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
        writes = c * t * 4 + c * h * w * 16 + c * t * (p + 1) * 4
        out["bytes"] = pairs["entries"] * (INDEX_BYTES + ROW_BYTES) + writes
        out["bytes_sector"] = (pairs["entries"]
                               * (INDEX_BYTES + ROW_SECTOR_BYTES) + writes)
        out["ops"], out["ops_walked"] = work(pairs, BLEND_OPS)
        out["pairs"] = pairs
        out["ms"] = device_ms(lambda: run_fwd(x, route), reps=50)
        out["ms_events"] = cuda_ms(lambda: run_fwd(x, route), reps=50)
        out["plain_ms"] = cuda_ms(lambda: comp.composite_tiles_plain(
            gat.gather_entries_plain(x["packed"], x["gidx"], x["valid"]),
            counts, *geometry(x)), reps=5, warmup=1)
    print(f"[kernel] composite_fwd ({route} route) {name}: max|kernel - "
          f"plain| = {err:.3e} ({n_over} values above {ATOL}), batches "
          f"{out['batches']} of {out['batches_without_exit']} without the "
          f"early exit, done as the plain early exit's in every tile "
          f"({n_near} within rounding of the threshold)", flush=True)
    check(err <= ATOL, f"{name}: kernel disagrees with the plain version "
          f"({err:.3e} > {ATOL})")
    return out


def small_inputs(kind, dev):
    """A small scene's compositing input at its own budgets."""
    import torch
    from starst3r_tpu_torch.splat.rasterize import _project_and_bin
    args, kw = small_scene(kind)
    t_args = [torch.as_tensor(a, device=dev) for a in args]
    packed, gidx, valid, counts, _ = _project_and_bin(
        *t_args, kw["width"], kw["height"], 1, 16,
        kw["max_tiles_per_gaussian"], kw["max_per_tile"], None)
    return case_inputs(packed, gidx, valid, counts, kw["height"],
                       kw["width"], 16, 2, 2)


def check_composite_kernel(stt, scene, dev):
    """composite_fwd, both routes, on the real render's inputs and on the
    two small scenes. Returns the timed packed case of the render and the
    render's inputs."""
    import torch
    from starst3r_tpu_torch.splat.rasterize import _project_and_bin
    from starst3r_tpu_torch.splat.train import render_inputs

    cfg = scene.config.splat
    h, w = scene.imgs[0].shape[:2]
    tile = cfg.tile_size
    tw, th = -(-w // tile), -(-h // tile)
    gauss = render_inputs(scene.gs_state.params, cfg, scene.gs_state.n_alive)
    w2c = torch.as_tensor(scene.w2c, dtype=torch.float32, device=dev)
    Ks = torch.as_tensor(scene.intrinsics, dtype=torch.float32, device=dev)
    packed, gidx, valid, counts, _ = _project_and_bin(
        *gauss, w2c, Ks, w, h, cfg.sh_degree, tile,
        cfg.max_tiles_per_gaussian, cfg.max_per_tile, None)
    render_in = case_inputs(packed, gidx, valid, counts, h, w, tile, tw, th)
    cases = [composite_case("render", render_in, "packed", timed=True),
             composite_case("render", render_in, "entries", timed=False)]
    for kind in ("wall", "multi"):
        x = small_inputs(kind, dev)
        for route in ("packed", "entries"):
            case = composite_case(kind, x, route, timed=False)
            if kind == "wall":
                check(case["batches"] < case["batches_without_exit"],
                      "the opaque wall did not stop early")
            else:
                check(int(x["counts"].max()) > 128,
                      "no tile has several batches")
            cases.append(case)
    return cases, render_in


def bound(n_bytes, n_ops):
    """(bound ms, what bounds it): the larger of bytes over the card's
    memory rate and float32 operations over its CUDA-core rate."""
    t_b, t_o = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def launch_counters():
    """{exported kernel function: the wrapper that counts its launches}."""
    from starst3r_tpu_torch.splat import composite as comp, gather as gat
    return {"composite_fwd_packed": comp.composite_packed_cuda,
            "composite_bwd_packed": comp.composite_packed_bwd_cuda,
            "composite_fwd": comp.composite_tiles_cuda,
            "composite_bwd": comp.composite_tiles_bwd_cuda,
            "gather_entries": gat.gather_entries_cuda}


def set_launches(value=0):
    """Set every kernel's launch count, and the counts of non-finite
    gradient elements out of the backward kernel's routes and the gather's
    backward, to ``value``."""
    from starst3r_tpu_torch.splat import composite as comp, gather as gat
    for wrapper in launch_counters().values():
        wrapper.launches = value
    comp.CompositePacked.nonfinite = value
    comp.CompositeTiles.nonfinite = value
    gat.GatherEntries.nonfinite = value


def read_launches():
    return {name: wrapper.launches
            for name, wrapper in launch_counters().items()}


def read_nonfinite():
    from starst3r_tpu_torch.splat import composite as comp, gather as gat
    return {"composite_bwd_packed": int(comp.CompositePacked.nonfinite),
            "composite_bwd": int(comp.CompositeTiles.nonfinite),
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


def run_bwd(x, route, fwd_out, g_rgb, g_alpha):
    """One launch of the backward kernel's route (its wrapper, zero fill
    included) on the forward's outputs: grad_packed (C*N, 9) on the packed
    route, grad_entries (C, T, K, 9) on the entries route."""
    from starst3r_tpu_torch.splat import composite as comp
    rgb, _, tfin, done = fwd_out
    if route == "packed":
        return comp.composite_packed_bwd_cuda(
            x["packed"], x["gidx"], x["counts"], rgb, tfin, done, g_rgb,
            g_alpha, *geometry(x))
    return comp.composite_tiles_bwd_cuda(x["entries"], x["counts"], rgb,
                                         tfin, done, g_rgb, g_alpha,
                                         *geometry(x))


def plain_bwd(x, route, done, g_rgb, g_alpha):
    from starst3r_tpu_torch.splat import composite as comp
    if route == "packed":
        return comp.composite_packed_bwd_plain(
            x["packed"], x["gidx"], x["counts"], done, g_rgb, g_alpha,
            *geometry(x))
    return comp.composite_tiles_bwd_plain(x["entries"], x["counts"], done,
                                          g_rgb, g_alpha, *geometry(x))


def scaled_errors(got, want):
    """Per attribute (the last axis), max |got - want| over want's largest
    magnitude."""
    return [float((got[..., a] - want[..., a]).abs().max())
            / max(float(want[..., a].abs().max()), 1e-12) for a in range(9)]


def bwd_case(name, x, route, g_rgb, g_alpha, timed, keep=False):
    """A backward route against its plain version on one input, on the
    forward kernel's outputs. Returns the scaled error and, when ``timed``,
    the two times and the work the data needs; when ``keep``, also the two
    gradients and the forward's ``done`` (for `k2_margin`)."""
    import torch

    counts = x["counts"]
    h, w, tile, tw, th = geometry(x)
    fwd_out = run_fwd(x, route)
    done = fwd_out[3]
    got = run_bwd(x, route, fwd_out, g_rgb, g_alpha)
    torch.cuda.synchronize()
    want = plain_bwd(x, route, done, g_rgb, g_alpha)
    check(bool(torch.isfinite(got).all()), f"{name}: gradient not finite")
    check_done(name, x["entries"], counts, done, tile, tw, th)
    errs = scaled_errors(got, want)
    err = max(errs)
    out = {"case": name, "scaled_err": err,
           "max_abs_err": float((got - want).abs().max())}
    if keep:
        out.update(got=got, want=want, done=done)
    if timed:
        c, t = counts.shape
        p = tile * tile
        pairs = pair_counts(x["entries"], counts, done, tile, tw, th)
        # reads: the entries walked (index and row), counts and done, T_fin,
        # rgb and the two pixel gradients; writes: a reduction add of 36
        # bytes into the table per entry that contributed (the rest of the
        # table is the caller's zeros)
        fixed = c * t * 8 + c * t * p * 4 + c * h * w * (12 + 12 + 4)
        n_walked, n_added = pairs["entries"], pairs["contributing"]
        out["bytes"] = (n_walked * (INDEX_BYTES + ROW_BYTES) + fixed
                        + n_added * ROW_BYTES)
        out["bytes_sector"] = (n_walked * (INDEX_BYTES + ROW_SECTOR_BYTES)
                               + fixed + n_added * ROW_SECTOR_BYTES)
        out["ops"], out["ops_walked"] = work(pairs, BWD_PASS_OPS)
        out["pairs"] = pairs
        out["ms"] = device_ms(lambda: run_bwd(x, route, fwd_out, g_rgb,
                                              g_alpha), reps=20)
        out["ms_events"] = cuda_ms(lambda: run_bwd(x, route, fwd_out, g_rgb,
                                                   g_alpha), reps=20)
        out["plain_ms"] = cuda_ms(lambda: plain_bwd(x, route, done, g_rgb,
                                                    g_alpha), reps=3,
                                  warmup=1)
    print(f"[kernel] composite_bwd ({route} route) {name}: max scaled "
          f"|kernel - plain| = {err:.3e} (per attribute "
          f"{[f'{e:.1e}' for e in errs]}), max abs "
          f"{out['max_abs_err']:.3e}", flush=True)
    check(err <= BWD_SCALED_TOL, f"{name}: backward kernel disagrees with "
          f"the plain version ({err:.3e} > {BWD_SCALED_TOL})")
    return out


def trained_inputs(scene, dev):
    """The trained scene at the tile budgets training picks: the
    compositing input (the gather's table and bins, the gathered entries),
    the bins, and the real loss's pixel gradients of its render."""
    import torch
    from starst3r_tpu_torch.ops.ssim import ssim_per_image
    from starst3r_tpu_torch.splat import composite as comp
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
    tile = scfg.tile_size
    tw, th = -(-w // tile), -(-h // tile)
    x = case_inputs(pack_attributes(proj), bins.gidx, bins.ent_valid,
                    bins.counts, h, w, tile, tw, th)
    rgb, alpha, _, _ = comp.composite_tiles_cuda(x["entries"], bins.counts,
                                                 h, w, tile, tw, th)
    gt = torch.as_tensor(np.stack(scene.imgs), dtype=torch.float32,
                         device=dev)
    rgb_x = rgb.detach().requires_grad_(True)
    f = cfg.loss_ssim_fac
    loss = torch.sum(torch.mean(torch.abs(gt - rgb_x), dim=(1, 2, 3))
                     * (1 - f) + (1.0 - ssim_per_image(gt, rgb_x)) * f)
    (g_rgb,) = torch.autograd.grad(loss, rgb_x)
    return dict(x=x, state=state, scfg=scfg, bins=bins, w2c=w2c, Ks=Ks, gt=gt,
                g_rgb=g_rgb.contiguous(), g_alpha=torch.zeros_like(alpha))


def check_bwd_kernel(real, dev):
    """composite_bwd, both routes, on the trained scene and the two small
    scenes. Returns the timed packed case of the trained scene and every
    case."""
    import torch

    cases = [bwd_case("trained", real["x"], route, real["g_rgb"],
                      real["g_alpha"], timed=route == "packed",
                      keep=route == "entries")
             for route in ("packed", "entries")]
    gen = torch.Generator(device=dev).manual_seed(0)
    for kind in ("wall", "multi"):
        x = small_inputs(kind, dev)
        c = x["counts"].shape[0]
        g_rgb = torch.randn((c, x["h"], x["w"], 3), generator=gen,
                            device=dev)
        g_alpha = torch.randn((c, x["h"], x["w"]), generator=gen, device=dev)
        cases += [bwd_case(kind, x, route, g_rgb, g_alpha, timed=False)
                  for route in ("packed", "entries")]
    return cases


def check_gather_kernel(real):
    """The standalone gather_entries against packed[gidx] * valid on the
    trained scene; times it, the plain version and the library's
    packed[gidx]."""
    import torch
    from starst3r_tpu_torch.splat import gather as gat

    x = real["x"]
    packed, gidx, valid = x["packed"], x["gidx"], x["valid"]
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
           "ms": device_ms(lambda: gat.gather_entries_cuda(packed, gidx,
                                                           valid), reps=50),
           "ms_events": cuda_ms(lambda: gat.gather_entries_cuda(
               packed, gidx, valid), reps=50),
           "plain_ms": cuda_ms(lambda: gat.gather_entries_plain(
               packed, gidx, valid), reps=20),
           "library_ms": device_ms(lambda: packed[gidx], reps=20)}
    print(f"[kernel] gather_entries on the trained scene: {tuple(gidx.shape)}"
          f" slots, {int(valid.sum())} valid, {n_rows} distinct rows; "
          f"max|kernel - plain| = {err}", flush=True)
    return out


def unfused_composite(packed, gidx, counts, h, w, tile, tw, th, chunk=128):
    """The chain the packed route replaced, with the packed route's
    signature: the standalone gather (GatherEntries, backward an
    index_add_) and the entries route (CompositeTiles)."""
    from starst3r_tpu_torch.splat import composite as comp
    from starst3r_tpu_torch.splat import gather as gat
    entries = gat.gather_entries(packed, gidx, comp.slot_valid(gidx, counts))
    return comp.composite_tiles(entries, counts, h, w, tile, tw, th, chunk)


def in_turns(fns, reps):
    """The device ms (`device_ms`) and the CUDA-event ms (`cuda_ms`, which
    also counts the host's launch pace) of each named launcher, in turns
    a, b, b, a, then each one's kernels under torch.profiler
    (`profiled_ms`, empty where the trace holds no device time):
    ({name: [ms, ms]}, {name: [ms, ms]}, {name: {kernel: ms}})."""
    (na, fa), (nb, fb) = fns.items()
    dev, events = {na: [], nb: []}, {na: [], nb: []}
    for name, fn in ((na, fa), (nb, fb), (nb, fb), (na, fa)):
        dev[name].append(device_ms(fn, reps=reps))
        events[name].append(cuda_ms(fn, reps=reps))
    kernels = {name: profiled_ms(fn, reps=reps)[1]
               for name, fn in ((na, fa), (nb, fb))}
    return dev, events, kernels


def fused_phase(render_in, real, dev):
    """[fused]: the packed routes against the unfused chains they replace,
    on the render's inputs and the trained scene, timed in turns (device
    time from `device_ms`, and CUDA events), and one training step on
    each route: its peak device memory and its device-busy time. Returns
    the numbers."""
    import importlib
    import torch
    from starst3r_tpu_torch.splat import composite as comp
    from starst3r_tpu_torch.splat import gather as gat
    from starst3r_tpu_torch.splat import train as tr
    # the module: the package's `rasterize` is the function
    rz = importlib.import_module("starst3r_tpu_torch.splat.rasterize")

    res = {}
    gen = torch.Generator(device=dev).manual_seed(1)
    for case, x in (("render", render_in), ("trained", real["x"])):
        geo = geometry(x)
        fused = comp.composite_packed_cuda(x["packed"], x["gidx"],
                                           x["counts"], *geo)
        ent = gat.gather_entries_cuda(x["packed"], x["gidx"], x["valid"])
        unfused = comp.composite_tiles_cuda(ent, x["counts"], *geo)
        torch.cuda.synchronize()
        for name, a, b in zip(("rgb", "alpha", "tfin", "done"), fused,
                              unfused):
            check(torch.equal(a, b), f"[fused] {case}: the packed forward's "
                  f"{name} differs from the gather and the entries route's")
        fwd = in_turns({
            "unfused": lambda: comp.composite_tiles_cuda(
                gat.gather_entries_cuda(x["packed"], x["gidx"], x["valid"]),
                x["counts"], *geo),
            "fused": lambda: comp.composite_packed_cuda(
                x["packed"], x["gidx"], x["counts"], *geo)}, reps=50)
        if case == "trained":
            g_rgb, g_alpha = real["g_rgb"], real["g_alpha"]
        else:
            c, h, w = x["counts"].shape[0], x["h"], x["w"]
            g_rgb = torch.randn((c, h, w, 3), generator=gen, device=dev)
            g_alpha = torch.randn((c, h, w), generator=gen, device=dev)
        rows = x["packed"].shape[0]
        valid9 = x["valid"][..., None]
        flat = x["gidx"].reshape(-1)

        def unfused_bwd():
            grad = comp.composite_tiles_bwd_cuda(ent, x["counts"], unfused[0],
                                                 unfused[2], unfused[3],
                                                 g_rgb, g_alpha, *geo)
            table = torch.zeros((rows, 9), device=dev)
            return table.index_add_(0, flat, (grad * valid9).reshape(-1, 9))

        def fused_bwd():
            return comp.composite_packed_bwd_cuda(
                x["packed"], x["gidx"], x["counts"], fused[0], fused[2],
                fused[3], g_rgb, g_alpha, *geo)

        got, want = fused_bwd(), unfused_bwd()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"[fused] {case}: the packed "
              "backward's gradient is not finite")
        errs = scaled_errors(got, want)
        check(max(errs) <= FUSED_SCALED_TOL, f"[fused] {case}: the packed "
              f"backward differs from the unfused chain by {max(errs):.3e} "
              f"(scaled) > {FUSED_SCALED_TOL}")
        bwd = in_turns({"unfused": unfused_bwd, "fused": fused_bwd}, reps=20)
        res[case] = {"fwd": fwd, "bwd": bwd, "bwd_scaled_err": max(errs)}
        for part, (dev_ms, ev_ms, kernels) in (("forward", fwd),
                                               ("backward", bwd)):
            print(f"[fused] {case} {part}: device ms unfused "
                  f"{np.mean(dev_ms['unfused']):.4f} {dev_ms['unfused']}, "
                  f"packed {np.mean(dev_ms['fused']):.4f} {dev_ms['fused']};"
                  f" CUDA-event ms unfused {np.mean(ev_ms['unfused']):.4f} "
                  f"{ev_ms['unfused']}, packed {np.mean(ev_ms['fused']):.4f}"
                  f" {ev_ms['fused']}", flush=True)
            for route, by in kernels.items():
                print(f"[fused]   {case} {part} {route}, torch.profiler: "
                      + ("; ".join(f"{ms:.4f} ms {name[:60]}"
                                   for name, ms in sorted(
                                       by.items(), key=lambda kv: -kv[1]))
                         or "no device time in the trace: not measured"),
                      flush=True)
        print(f"[fused] {case}: the packed forward's rgb, alpha, T_fin and "
              "done equal the gather + entries route's bit for bit; max "
              f"scaled |packed - unfused| of the backward {max(errs):.3e}",
              flush=True)

    # one training step on each route, the same state and bins
    state, scfg, bins = real["state"], real["scfg"], real["bins"]
    x = real["x"]

    def step():
        tr.train_step(state, real["gt"], real["w2c"], real["Ks"], x["w"],
                      x["h"], scfg, x["counts"].shape[0], bins=bins)

    routes = {"unfused": unfused_composite, "fused": comp.composite_packed}
    peak, busy, launched = {}, {}, {}
    try:
        for route in ("unfused", "fused", "fused", "unfused") * 2:
            rz.composite_packed = routes[route]
            step()                                  # warm
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            set_launches(0)
            step()
            torch.cuda.synchronize()
            launched[route] = read_launches()
            peak.setdefault(route, []).append(
                torch.cuda.max_memory_allocated(dev) - base)
            busy.setdefault(route, []).append(profiled_ms(step, reps=10)[0])
    finally:
        rz.composite_packed = comp.composite_packed
    check(launched["fused"]["gather_entries"] == 0
          and launched["fused"]["composite_bwd_packed"] == 1,
          f"[fused] the packed step launched {launched['fused']}")
    check(launched["unfused"]["gather_entries"] == 1
          and launched["unfused"]["composite_bwd"] == 1,
          f"[fused] the unfused step launched {launched['unfused']}")
    res["step"] = {"peak_bytes": peak, "busy_ms": busy}
    mib = {k: [round(b / 2**20, 3) for b in v] for k, v in peak.items()}
    # a turn whose trace held no device time is None: not measured
    busy_ms = {k: [None if b is None else round(b, 4) for b in v]
               for k, v in busy.items()}
    means = {k: round(float(np.mean(got)), 4) if got else None
             for k, got in ((k, [b for b in v if b is not None])
                            for k, v in busy.items())}
    print(f"[fused] one training step (train_step on the trained scene's "
          f"state and bins, {x['counts'].shape[0]} cameras), in turns "
          f"(unfused, fused, fused, unfused) twice: peak device memory above "
          f"the step's start {mib} MiB; device busy per step "
          f"(torch.profiler, 10 steps a turn; None: no device time in the "
          f"trace) {busy_ms} ms, means {means} ms; launches of the measured "
          f"step {launched}", flush=True)
    return res


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
    for case, x in (("render", render_in), ("trained", real["x"])):
        args = (x["entries"], x["counts"]) + geometry(x)
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


def register_phase(model, scene):
    """`[register]`: one more view registered against the trained scene
    with every earlier camera frozen. Returns the host seconds."""
    view = make_views(N_VIEWS + 1, HW)[N_VIEWS]
    before = {k: getattr(scene.optim_params, k).clone()
              for k in ("quats", "trans", "core_depth")}
    n_rec = len(scene.logger.records)
    t = time.perf_counter()
    c2w_new = scene.register_camera(model, view, conf_thres=1.0)
    secs = time.perf_counter() - t
    (rec,) = [r for r in scene.logger.records[n_rec:]
              if r["event"] == "reconstruct"]
    moved = {k: float((getattr(scene.optim_params, k)[:N_VIEWS]
                       - v).abs().max()) for k, v in before.items()}
    print(f"[register] register_camera of a 7th view: {secs:.3f} s "
          f"(inference {rec['inference']:.3f} s for the new pairs, ga "
          f"{rec['ga']:.3f} s); the frozen cameras' chain parameters moved "
          f"by at most {moved} (limit {REGISTER_TOL}); the new camera's "
          f"centre {np.round(c2w_new[:3, 3], 6).tolist()}", flush=True)
    check(rec["n_pairs"] == N_VIEWS * (N_VIEWS + 1),
          f"register_camera ran {rec['n_pairs']} pairs")
    check(isinstance(c2w_new, np.ndarray) and c2w_new.shape == (4, 4)
          and np.isfinite(c2w_new).all(), "the new camera's c2w")
    check(np.asarray(scene.c2w).shape == (N_VIEWS + 1, 4, 4),
          f"scene.c2w {np.asarray(scene.c2w).shape}")
    check(np.isfinite(scene.c2w).all() and np.isfinite(
        scene.intrinsics).all(), "poses or intrinsics not finite")
    for k, v in moved.items():
        check(v <= REGISTER_TOL, f"frozen {k} moved by {v}")
    check(scene.optim_params.quats.is_cuda, "the GA left the card")
    return {"register_ga": rec["ga"], "register_total": secs}


def _free_bytes(path):
    import shutil
    return shutil.disk_usage(path).free


def checkpoint_phase(stt, model, scene, work_dir):
    """`[checkpoint]`: the trained scene and the large model through
    save/load on the card, bit for bit, and 10 training steps on the
    loaded scene. Returns the seconds of each operation."""
    import torch
    secs = {}
    path = os.path.join(work_dir, "scene.ckpt")
    t = time.perf_counter()
    scene.save(path)
    secs["scene_save"] = time.perf_counter() - t
    t = time.perf_counter()
    back = stt.Scene.load(path, config=scene.config, device="cuda")
    torch.cuda.synchronize()
    secs["scene_load"] = time.perf_counter() - t
    scene_bytes = os.path.getsize(path)
    check(back.device.type == "cuda", f"loaded scene on {back.device}")
    for name in ("c2w", "intrinsics"):
        check(np.array_equal(getattr(back, name), getattr(scene, name)),
              f"loaded {name} differs")
    for name in ("raw_imgs", "imgs"):
        check(np.array_equal(np.stack(getattr(back, name)),
                             np.stack(getattr(scene, name))),
              f"loaded {name} differ")
    for field, a, b in zip(scene.optim_params._fields, back.optim_params,
                           scene.optim_params):
        check(a.is_cuda and torch.equal(a, b), f"loaded optim_params.{field}")
    for k, v in scene.gs_state.params.items():
        got = back.gs_state.params[k]
        check(got.is_cuda and torch.equal(got, v), f"loaded gaussians/{k}")
    check(back.gs_state.n_alive == scene.gs_state.n_alive,
          "loaded n_alive differs")
    t = time.perf_counter()
    losses = back.run_3dgs_optim(10, enable_pruning=True)
    torch.cuda.synchronize()
    secs["train_10_after_load"] = time.perf_counter() - t
    check(len(losses) == 10 and all(np.isfinite(losses)),
          f"losses after load: {losses}")
    del back

    n_bytes = 4 * sum(p.numel() for p in model.net.parameters())
    free = _free_bytes(work_dir)
    check(free > 1.5 * n_bytes, f"save_pretrained needs ~{n_bytes} bytes "
          f"in {work_dir}, {free} are free: give the run a TMPDIR with "
          "room for the large model")
    base = os.path.join(work_dir, "model")
    t = time.perf_counter()
    model.save_pretrained(base)
    secs["model_save"] = time.perf_counter() - t
    model_bytes = os.path.getsize(base + ".npz")
    t = time.perf_counter()
    loaded = stt.Mast3rModel.from_pretrained(base + ".npz", device="cuda")
    torch.cuda.synchronize()
    secs["model_load"] = time.perf_counter() - t
    want, got = model.state_dict(), loaded.state_dict()
    check(sorted(got) == sorted(want), "loaded model's keys differ")
    unequal = [k for k in want if not torch.equal(got[k], want[k])]
    check(not unequal, f"loaded weights differ: {unequal[:5]}")
    views = make_views(2, HW, seed=1)
    img1, img2 = (torch.from_numpy(np.ascontiguousarray(
        v.transpose(1, 2, 0)[None])).cuda() for v in views)
    a = model.infer_pair_batch(img1, img2)
    b = loaded.infer_pair_batch(img1, img2)
    err = {k: float((a[k] - b[k]).abs().max()) for k in OUT_ATOL}
    for k, atol in OUT_ATOL.items():
        check(torch.allclose(b[k], a[k], atol=atol, rtol=2e-3),
              f"loaded model's {k} differs by {err[k]}")
    del loaded
    torch.cuda.empty_cache()
    print(f"[checkpoint] scene.ckpt {scene_bytes} B: save "
          f"{secs['scene_save']:.3f} s, load {secs['scene_load']:.3f} s, "
          "every array equal bit for bit; 10 training steps on the loaded "
          f"scene {secs['train_10_after_load']:.3f} s, loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}", flush=True)
    print(f"[checkpoint] model.npz {model_bytes} B: save_pretrained "
          f"{secs['model_save']:.3f} s, from_pretrained "
          f"{secs['model_load']:.3f} s, {len(want)} tensors equal bit for "
          f"bit; one pair through both models: max |difference| {err}",
          flush=True)
    return {f"checkpoint_{k}": v for k, v in secs.items()}


def polish_phase(stt, model, views, dev, cache_dir):
    """`[polish]`: reconstruct_scene on the six views (every pair from the
    cache) with spectral low-rank depth and the LM polish, then with the
    Schur polish. Returns the stage seconds."""
    import dataclasses
    from starst3r_tpu_torch.utils.metrics import MetricsLogger
    secs = {}
    for name, ga in POLISH.items():
        cfg = stt.default_config()
        cfg = dataclasses.replace(cfg, ga=dataclasses.replace(cfg.ga, **ga))
        logger = MetricsLogger()
        rec, params = stt.reconstruct_scene(model, views, device=dev,
                                            tmpdir=cache_dir, config=cfg,
                                            logger=logger)
        (lm,) = [r for r in logger.records if r["event"] == "lm_refine"]
        (summary,) = [r for r in logger.records
                      if r["event"] == "reconstruct"]
        costs = lm["costs"]
        lowered = sum(b < a for a, b in zip(costs, costs[1:]))
        stages = {k: summary[k] for k in ("inference", "lora_basis", "ga",
                                          "lm_refine") if k in summary}
        secs.update({f"{name}_{k}": v for k, v in stages.items()})
        focals = rec.intrinsics[:, 0, 0]
        print(f"[polish] {name} ({ga}): " + " ".join(
            f"{k}={v:.3f}s" for k, v in stages.items())
            + f"; GA loss {rec.losses}; cost first {costs[0]:.6g} last "
            f"{costs[-1]:.6g} over {len(costs)} iterations, {lowered} "
            "steps after the first lowered it"
            + (" (no correspondence has weight: every pair's best match "
               "confidence is below matching_conf_thr)"
               if max(costs) == 0 else "") + "; focals "
            f"{np.round(focals, 3).tolist()}; core depth "
            f"{tuple(params.core_depth.shape)}", flush=True)
        check(summary["n_pairs"] == N_VIEWS * (N_VIEWS - 1),
              f"{name}: {summary['n_pairs']} pairs")
        check(all(b <= a for a, b in zip(costs, costs[1:])),
              f"{name}: the polish's cost rose: {costs}")
        check(costs[-1] <= costs[0], f"{name}: last cost above the first")
        check(np.isfinite(rec.cam2w).all() and np.isfinite(focals).all(),
              f"{name}: poses or focals not finite")
        if cfg.ga.lora_depth:
            check(tuple(params.core_depth.shape) == (N_VIEWS, cfg.ga.lora_k),
                  f"{name}: lora coefficients {params.core_depth.shape}")
    secs.update(planted_polish(dev))
    return secs


def planted_ba(rng, c, npts, f=250.0):
    """A planted polish problem at the main path's size: c cameras on a
    path observing npts shared world points, each camera's exact pixels
    and depths in its own section of the core grid, every pair of cameras
    matched (zero residual at the planted poses), and a perturbed start
    with camera 0 kept."""
    def rotz(a):
        return np.array([[np.cos(a), -np.sin(a), 0],
                         [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    pps = np.full((c, 2), HW / 2, np.float32)
    cam2w = np.tile(np.eye(4, dtype=np.float32)[None], (c, 1, 1))
    for i in range(c):
        cam2w[i, :3, :3] = rotz(0.03 * i)
        cam2w[i, :3, 3] = [0.15 * i, 0.03 * i, -0.05 * i]
    world = rng.uniform(-1.5, 1.5, size=(npts, 3)).astype(np.float32)
    world[:, 2] += 6.0
    core_pix = np.zeros((c * npts, 2), np.float32)
    depths = np.ones((c, c * npts), np.float32)
    for i in range(c):
        w2c = np.linalg.inv(cam2w[i])
        p = world @ w2c[:3, :3].T + w2c[:3, 3]
        sl = slice(i * npts, (i + 1) * npts)
        core_pix[sl] = p[:, :2] / p[:, 2:3] * f + pps[i]
        depths[i, sl] = p[:, 2]
    pairs = [(i, j) for i in range(c) for j in range(i + 1, c)]
    ar = np.arange(npts)
    corr = [np.concatenate(x).astype(np.int32) for x in zip(*[
        (np.full(npts, i), i * npts + ar, np.full(npts, j), j * npts + ar)
        for i, j in pairs])]
    noisy = cam2w.copy()
    for i in range(1, c):
        noisy[i, :3, :3] = rotz(rng.normal() * 0.03) @ noisy[i, :3, :3]
        noisy[i, :3, 3] += rng.normal(size=3) * 0.08
    return (cam2w, noisy, np.full(c, f, np.float32), pps, depths, core_pix,
            corr, np.ones(len(corr[0]), np.float32))


def planted_polish(dev):
    """The polish's numbers on the card at the main path's size (six
    cameras, 784 core points each, every pair matched): both refiners
    from a perturbed start must bring the cost below 1e-4 of its first
    value and the poses within 1e-2 of the planted ones
    (tests/test_lm.py's bounds). Returns the seconds."""
    import torch
    from starst3r_tpu_torch.alignment.lm import lm_refine
    from starst3r_tpu_torch.alignment.schur import build_tracks, schur_refine
    gt, noisy, focals, pps, depths, core_pix, corr, conf = planted_ba(
        np.random.default_rng(0), N_VIEWS, (HW // 8) ** 2)
    tracks = build_tracks(*corr[:2], *corr[2:], conf, N_VIEWS,
                          core_pix.shape[0], max_obs=8)
    secs = {}
    for name, run in (
            ("lm", lambda: lm_refine(noisy, focals, pps, depths, core_pix,
                                     *corr, conf, iters=12, device=dev)),
            ("schur", lambda: schur_refine(noisy, focals, pps, depths,
                                           core_pix, tracks, iters=12,
                                           device=dev))):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, f_out, costs = run()
        secs[f"planted_{name}"] = time.perf_counter() - t
        t_err = float(np.abs(out[:, :3, 3] - gt[:, :3, 3]).max())
        r_err = float(np.abs(out[:, :3, :3] - gt[:, :3, :3]).max())
        print(f"[polish] planted, {name}: {len(corr[0])} correspondences, "
              f"{tracks.cam.shape[0]} tracks; {secs[f'planted_{name}']:.3f}"
              f" s for 12 iterations; cost {costs[0]:.6g} -> "
              f"{costs[-1]:.6g}; pose error translation {t_err:.3g}, "
              f"rotation {r_err:.3g}; focal error "
              f"{float(np.abs(f_out / focals - 1).max()):.3g}", flush=True)
        check(all(b <= a for a, b in zip(costs, costs[1:])),
              f"planted {name}: the cost rose: {costs}")
        check(costs[-1] < 1e-4 * costs[0], f"planted {name}: cost "
              f"{costs[0]} -> {costs[-1]}")
        check(t_err < 1e-2 and r_err < 1e-2,
              f"planted {name}: pose errors {t_err}, {r_err}")
    return secs


def write_view_pngs(views, imgdir):
    """The views as the PNG files a user would point the CLI at."""
    from PIL import Image
    from starst3r_tpu_torch.imaging import image_to_uint8
    os.makedirs(imgdir, exist_ok=True)
    for i, v in enumerate(views):
        Image.fromarray(image_to_uint8(v)).save(
            os.path.join(imgdir, f"view_{i}.png"))


def cli_run(cli, args):
    """One in-process CLI call with every launch count set to 0 just
    before it. Returns (rc, seconds, launches)."""
    import torch
    set_launches(0)
    t = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t, read_launches()


def trace_device_events(trace_dir, label):
    """The number of device events (kernels, copies, fills) in the traces
    under ``<trace_dir>/<label>/``, and the number of trace files."""
    path = os.path.join(trace_dir, label)
    files = [f for f in os.listdir(path) if f.endswith(".json")] \
        if os.path.isdir(path) else []
    n = 0
    for f in files:
        with open(os.path.join(path, f)) as fh:
            events = json.load(fh).get("traceEvents", [])
        n += sum(1 for e in events if e.get("cat") in CUDA_EVENT_CATS)
    return n, len(files)


def cli_phase(stt, views, model_npz, work_dir):
    """`[cli]`: the port's command line the way its users start it, at
    full width: reconstruct (the large model's checkpoint, the six views
    as PNG files, fed 4 then 2 through add_images, 50 training steps),
    train-gs, render-path and export-ply in process, with the launch
    counts read around each; then `info` and a traced reconstruct through
    `python -m starst3r_tpu_torch` in subprocesses. Returns the seconds."""
    from PIL import Image
    from starst3r_tpu_torch import cli
    from starst3r_tpu_torch.io.ply import load_ply

    root = os.path.join(work_dir, "cli")
    imgdir, out = os.path.join(root, "views"), os.path.join(root, "out")
    frames_dir = os.path.join(root, "frames")
    write_view_pngs(views, imgdir)
    ckpt = os.path.join(out, "scene.ckpt")
    rec_args = ["--imgdir", imgdir, "--res", str(HW), "--preset", "large",
                "--model", model_npz, "--conf-thres", "1.0"]
    saved = []
    save = stt.Scene.save

    def keep(scene, path):
        saved.append(scene)
        return save(scene, path)

    stt.Scene.save = keep
    try:
        runs = {
            "reconstruct": ["reconstruct", "--out", out, "--incremental-batch",
                            "4", "--gs-iters", str(CLI_STEPS)] + rec_args,
            "train-gs": ["train-gs", "--scene", ckpt, "--iters",
                         str(CLI_STEPS)],
            "render-path": ["render-path", "--scene", ckpt, "--out",
                            frames_dir, "--steps", str(N_NOVEL),
                            "--cameras", f"0,{N_VIEWS - 1}"],
            "export-ply": ["export-ply", "--scene", ckpt, "--out",
                           os.path.join(root, "gaussians.ply")],
        }
        secs, launches = {}, {}
        for name, args in runs.items():
            rc, secs[name], launches[name] = cli_run(cli, args)
            print(f"[cli] {name}: rc {rc}, {secs[name]:.3f} s, launches "
                  f"{launches[name]}", flush=True)
            check(rc == 0, f"cli {name} exited {rc}")
    finally:
        stt.Scene.save = save
    scene = saved[0]
    check(scene.device.type == "cuda", f"the CLI's scene on {scene.device}")
    for f in ("scene.ckpt", "points.ply", "c2w.npy", "intrinsics.npy",
              "metrics.jsonl"):
        check(os.path.exists(os.path.join(out, f)), f"cli wrote no {f}")
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    (load,) = [r for r in records if r["event"] == "load_images"]
    check(load["impl"] == "native", f"the CLI loaded its images through "
          f"the {load['impl']} route, not the native one")
    check([r["n_images"] for r in records if r["event"] == "reconstruct"]
          == [4, N_VIEWS], "add_images did not run on 4, then 6 views")
    pts, cols = load_ply(os.path.join(out, "points.ply"))
    n_dense = scene.dense_pts_flat.shape[0]
    check(pts.shape == (n_dense, 3) and cols is not None,
          f"points.ply holds {pts.shape[0]} points, the scene {n_dense}")
    check(np.isfinite(pts).all(), "points.ply not finite")
    check(np.array_equal(np.load(os.path.join(out, "c2w.npy")), scene.c2w),
          "c2w.npy differs from the scene's poses")
    frames = sorted(f for f in os.listdir(frames_dir) if f.endswith(".png"))
    check(len(frames) == N_NOVEL, f"render-path wrote {len(frames)} frames")
    stack = np.stack([np.asarray(Image.open(os.path.join(frames_dir, f)))
                      for f in frames])
    check(stack.shape == (N_NOVEL, HW, HW, 3), f"frames {stack.shape}")
    check(float(stack.std()) > 0, "render-path's frames are uniform")
    gpts, _ = load_ply(os.path.join(root, "gaussians.ply"))
    check(gpts.shape[0] > 0 and np.isfinite(gpts).all(),
          "export-ply's points")
    for name in ("reconstruct", "train-gs"):
        for fn in ("composite_fwd_packed", "composite_bwd_packed"):
            check(launches[name][fn] > 0, f"cli {name} did not launch {fn}")
    check(launches["render-path"]["composite_fwd_packed"] > 0,
          "cli render-path did not launch composite_fwd_packed")
    for name, got in launches.items():
        check(got["gather_entries"] == 0,
              f"cli {name} launched the standalone gather")

    # `python -m starst3r_tpu_torch`: info, and a traced reconstruct
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [here] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "starst3r_tpu_torch",
                           "info"], capture_output=True, text=True,
                          timeout=300, env=env, cwd=here)
    secs["info"] = time.perf_counter() - t
    check(proc.returncode == 0, f"info exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    info = json.loads(proc.stdout)
    import torch
    card = torch.cuda.get_device_name(0)
    check(any(card in d for d in info["devices"]),
          f"info does not name the card: {info['devices']}")
    print(f"[cli] info: {json.dumps(info)}", flush=True)
    trace_dir = os.path.join(root, "trace")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "starst3r_tpu_torch", "--trace-dir",
         trace_dir, "reconstruct", "--out", os.path.join(root, "traced"),
         "--ga-iters1", "30", "--ga-iters2", "10", "--gs-iters", "5"]
        + rec_args, capture_output=True, text=True, timeout=900, env=env,
        cwd=here)
    secs["traced_reconstruct"] = time.perf_counter() - t
    check(proc.returncode == 0, f"the traced reconstruct exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    events = {}
    for label in ("inference", "ga", "splat_optim"):
        n, n_files = trace_device_events(trace_dir, label)
        check(n_files > 0, f"no {label} trace under {trace_dir}")
        events[label] = n
    print(f"[cli] traced reconstruct (--trace-dir, in a subprocess): "
          f"{secs['traced_reconstruct']:.3f} s; device events in the "
          f"traces {events} (reported, not checked)", flush=True)
    print(f"[cli] points.ply {pts.shape[0]} points = the scene's dense "
          f"points; gaussians.ply {gpts.shape[0]} points; {len(frames)} "
          f"frames, mean {float(stack.mean()):.3f} std "
          f"{float(stack.std()):.3f}; images through the {load['impl']} "
          "route", flush=True)
    print("[stages] cli: " + " ".join(f"{k}={v:.3f}s"
                                      for k, v in secs.items()), flush=True)
    return {f"cli_{k}": v for k, v in secs.items()}


def traj_scale(gt):
    return float(np.linalg.norm(gt[:, :3, 3] - gt[:, :3, 3].mean(0),
                                axis=1).max())


def planted_ga_phase(dev):
    """`[planted-ga]`: the GA on the card recovers planted cameras, with
    the port's own planted scenes and trajectory metrics
    (tests/test_ga_groundtruth.py's instances and bounds). Returns the
    seconds."""
    import torch
    from starst3r_tpu_torch.alignment.ga import run_global_alignment
    from starst3r_tpu_torch.config import GAConfig
    from starst3r_tpu_torch.utils.eval import ate_rmse, rpe_rotation_deg
    from starst3r_tpu_torch.utils.synthetic import synthetic_ga_scene
    secs = {}
    for name, kw, cfg, bound in (
            ("snapped", {}, GAConfig(niter1=300, niter2=120), 0.12),
            ("snap_free", {"snap_free": True},
             GAConfig(niter1=500, niter2=0), 0.001)):
        data, mst, gt, _ = synthetic_ga_scene(n_cams=4, hw=128, focal=180.0,
                                              subsample=4, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res, _ = run_global_alignment(data, mst, cfg, device=dev)
        pred = res.cam2w.cpu().numpy()
        secs[f"planted_ga_{name}"] = time.perf_counter() - t
        ate, rpe, scale = ate_rmse(pred, gt), rpe_rotation_deg(pred, gt), \
            traj_scale(gt)
        print(f"[planted-ga] {name}: GA {cfg.niter1} + {cfg.niter2} steps "
              f"in {secs[f'planted_ga_{name}']:.3f} s; ATE {ate:.6g} = "
              f"{ate / scale:.6g} x the trajectory scale {scale:.4f} "
              f"(limit {bound}); RPE {rpe:.4f} deg", flush=True)
        check(np.isfinite(pred).all(), f"planted {name}: poses not finite")
        check(ate < bound * scale, f"planted {name}: ATE {ate} >= "
              f"{bound} x {scale}")
        if name == "snapped":
            check(rpe < 8.0, f"planted {name}: RPE {rpe} deg >= 8")
    return secs


def turntable_phase():
    """`[turntable]`: examples/turntable_torch.py's recipe at its defaults
    on the card (128 px, 8 cameras, GA 500 + 200, 600 training steps, 48
    frames), with the launch counts read around it. Returns the seconds."""
    import importlib.util
    from starst3r_tpu_torch.utils.eval import ate_rmse
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "turntable_torch", os.path.join(here, "examples",
                                        "turntable_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    set_launches(0)
    out = mod.turntable(hw=128, iters=600, frames=48, device="cuda")
    launches = read_launches()
    gt = out["gt_c2w"]
    ate = ate_rmse(out["ga"].cam2w.cpu().numpy(), gt)
    scale = traj_scale(gt)
    losses = out["losses"]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    frames = out["frames"]
    per_seg = 48 // 14 + 1
    want_frames = per_seg + 13 * (per_seg - 1)
    print(f"[turntable] GA 500 + 200 steps {out['ga_s']:.3f} s, ATE "
          f"{ate:.6g} = {ate / scale:.6g} x the trajectory scale; 3DGS 600 "
          f"steps {out['gs_s']:.3f} s, loss first {losses[0]:.6f} last "
          f"{losses[-1]:.6f} (mean of the first 20 {first:.6f}, of the "
          f"last 20 {last:.6f}), n_alive {out['state'].n_alive}; "
          f"training-view PSNR at the recovered poses {out['psnr']:.4f} dB;"
          f" {len(frames)} orbit frames; launches {launches}", flush=True)
    check(ate < 0.12 * scale, f"turntable: ATE {ate} >= 0.12 x {scale}")
    check(all(np.isfinite(losses)) and len(losses) == 600,
          "turntable: a loss is not finite")
    check(last < first, f"turntable: the loss did not fall ({first} -> "
          f"{last})")
    check(np.isfinite(out["psnr"]), "turntable: PSNR not finite")
    check(frames.shape == (want_frames, 128, 128, 3),
          f"turntable: frames {frames.shape}")
    check(float(frames.std()) > 0, "turntable: the frames are uniform")
    for fn in ("composite_fwd_packed", "composite_bwd_packed"):
        check(launches[fn] > 0, f"turntable did not launch {fn}")
    return {"turntable_ga": out["ga_s"], "turntable_3dgs": out["gs_s"]}


def scaled_err(got, want):
    """max |got - want| over the largest |want|, in float64, over the
    entries finite in both (they must be finite in the same places)."""
    import torch
    a = torch.as_tensor(got).double().cpu()
    b = torch.as_tensor(want).double().cpu()
    fin = torch.isfinite(b)
    check(bool((torch.isfinite(a) == fin).all()),
          "non-finite values in different places")
    if not bool(fin.any()):
        return 0.0
    den = float(b[fin].abs().max())
    return float((a[fin] - b[fin]).abs().max()) / max(den, 1e-30)


def rel_steps(got, want):
    """|got - want| / |want| per step."""
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want) / np.abs(want)


def relative_poses(c2w):
    """Each camera in camera 0's frame: the GA leaves the scene's rigid
    motion free (its gauge), so two runs agree only up to it."""
    c2w = np.asarray(c2w, np.float64)
    return np.linalg.inv(c2w[0])[None] @ c2w


def par_train_inputs(scene):
    """The training arguments of `[parallel]`: Scene.run_3dgs_optim's, with
    the scene's MCMC schedule (one refine in PAR_STEPS steps)."""
    import dataclasses
    from starst3r_tpu_torch.splat.train import mcmc_config_from
    cfg = dataclasses.replace(scene.config.splat, loss_ssim_fac=0.2,
                              loss_opacity_fac=0.01, loss_scale_fac=0.01)
    return (np.stack(scene.imgs), scene.w2c, scene.intrinsics, cfg,
            mcmc_config_from(cfg))


def copy_state(state):
    """A GSState with its own generator at the same state (training draws
    from it)."""
    import torch
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    return state._replace(generator=gen)


def par_polish(dev, mesh=None):
    """Both refiners on `planted_polish`'s problem, 3 iterations as the JAX
    tests hold a sharded run to a meshless one: {name: (cam2w, costs)}."""
    from starst3r_tpu_torch.alignment.lm import lm_refine
    from starst3r_tpu_torch.alignment.schur import build_tracks, schur_refine
    _, noisy, focals, pps, depths, core_pix, corr, conf = planted_ba(
        np.random.default_rng(0), N_VIEWS, (HW // 8) ** 2)
    tracks = build_tracks(*corr[:2], *corr[2:], conf, N_VIEWS,
                          core_pix.shape[0], max_obs=8)
    out = {}
    out["lm"] = lm_refine(noisy, focals, pps, depths, core_pix, *corr, conf,
                          iters=3, mesh=mesh, device=dev)
    out["schur"] = schur_refine(noisy, focals, pps, depths, core_pix, tracks,
                                iters=3, mesh=mesh, device=dev)
    return {k: (np.asarray(v[0]), [float(c) for c in v[2]])
            for k, v in out.items()}


def check_polish(tag, got, want):
    for name, (c2w, costs) in got.items():
        w_c2w, w_costs = want[name]
        pose = float(np.abs(c2w - w_c2w).max())
        print(f"[parallel] {tag} {name}: poses within {pose:.3g} of the "
              f"meshless run's (limit {PAR_POSE_ATOL}); costs "
              f"{[float(f'{c:.6g}') for c in costs]}, the meshless run's "
              f"{[float(f'{c:.6g}') for c in w_costs]} (the last below "
              f"{PAR_CONVERGED} of the first)", flush=True)
        check(pose <= PAR_POSE_ATOL, f"{tag} {name}: poses off by {pose}")
        check(len(costs) == len(w_costs)
              and costs[-1] < PAR_CONVERGED * costs[0],
              f"{tag} {name}: did not converge: {costs}")


def parallel_phase(stt, model, views, scene, dev, work_dir):
    """`[parallel]`: the sharded paths, held to the meshless runs. (a) In
    this process, world size 1 over NCCL: pair-parallel inference against
    the meshless predictions; reconstruct_scene with and without the mesh
    (cache off, GA PAR_GA steps) within the GA's gauge; run_optim(mesh=)
    for PAR_STEPS steps from the trained scene, with the kernels' launches
    counted, against the meshless run's losses; the sharded polish on the
    planted problem. (b) Two ranks on the one card over gloo, each its own
    interpreter (`parallel_rank`): tensor parallelism of the large model,
    the same training against (a)'s meshless losses, the polish. Returns
    the seconds and the training's launch counts."""
    import torch
    import torch.distributed as dist
    from starst3r_tpu_torch.imaging import make_pair_indices
    from starst3r_tpu_torch.parallel import (initialize_distributed,
                                             make_mesh, pair_sharding)
    from starst3r_tpu_torch.splat.train import run_optim
    secs = {}
    t0 = time.perf_counter()
    initialize_distributed(device=dev)
    check(dist.get_world_size() == 1,
          f"{dist.get_backend()} world of {dist.get_world_size()}")
    mesh = make_mesh()

    pairs = make_pair_indices(N_VIEWS, symmetric=True)
    t = time.perf_counter()
    ref = model.infer_pairs(views, pairs)
    got = model.infer_pairs(views, pairs, sharding=pair_sharding(mesh))
    torch.cuda.synchronize()
    secs["par_infer"] = time.perf_counter() - t
    err = max(scaled_err(torch.stack([getattr(p, f) for p in got]),
                         torch.stack([getattr(p, f) for p in ref]))
              for f in ("pts1", "conf1", "pts2", "conf2", "desc1", "desc2",
                        "desc_conf1", "desc_conf2"))
    print(f"[parallel] world 1 (nccl): infer_pairs(sharding=) over "
          f"{len(pairs)} pairs, largest scaled difference from the meshless "
          f"predictions {err:.3g} (limit {PAR_INFER_TOL})", flush=True)
    check(err <= PAR_INFER_TOL, f"pair-parallel predictions off by {err}")

    import dataclasses
    cfg = stt.default_config()
    cfg = dataclasses.replace(
        cfg, ga=dataclasses.replace(cfg.ga, niter1=PAR_GA[0],
                                    niter2=PAR_GA[1]),
        scene=dataclasses.replace(cfg.scene, cache_dir=None))
    t = time.perf_counter()
    rec1, _ = stt.reconstruct_scene(model, views, device=dev, config=cfg)
    recm, _ = stt.reconstruct_scene(model, views, device=dev, config=cfg,
                                    mesh=mesh)
    secs["par_reconstruct"] = time.perf_counter() - t
    r1, rm = relative_poses(rec1.cam2w), relative_poses(recm.cam2w)
    scale = max(traj_scale(r1), 1e-12)
    t_err = float(np.abs(rm[:, :3, 3] - r1[:, :3, 3]).max()) / scale
    r_err = float(np.abs(rm[:, :3, :3] - r1[:, :3, :3]).max())
    k_err = scaled_err(recm.intrinsics, rec1.intrinsics)
    pts = recm.get_dense_pts3d()[0]
    print(f"[parallel] reconstruct_scene(mesh=) against the meshless run "
          f"(GA {PAR_GA[0]} + {PAR_GA[1]}, cache off): poses in camera 0's "
          f"frame within {t_err:.3g} x the trajectory scale {scale:.4g} "
          f"(translation) and {r_err:.3g} (rotation), intrinsics within "
          f"{k_err:.3g} of their largest (limit {PAR_GA_TOL} each); GA losses "
          f"{rec1.losses} / {recm.losses}", flush=True)
    check(all(np.isfinite(p).all() for p in pts), "dense points not finite")
    check(max(t_err, r_err, k_err) <= PAR_GA_TOL,
          f"the mesh's reconstruction is off: {t_err}, {r_err}, {k_err}")

    gt, w2c, Ks, tcfg, mcfg = par_train_inputs(scene)
    state = scene.gs_state
    torch.save({"params": {k: v.cpu() for k, v in state.params.items()},
                "mu": {k: v.cpu() for k, v in state.opt_state.mu.items()},
                "nu": {k: v.cpu() for k, v in state.opt_state.nu.items()},
                "count": state.opt_state.count, "step": state.step,
                "n_alive": state.n_alive,
                "generator": state.generator.get_state(), "gt": gt,
                "w2c": w2c, "Ks": Ks, "cfg": tcfg, "mcfg": mcfg,
                "steps": PAR_STEPS},
               os.path.join(work_dir, "par_state.pt"))
    t = time.perf_counter()
    _, losses1 = run_optim(copy_state(state), gt, w2c, Ks, PAR_STEPS, tcfg,
                           enable_pruning=True, mcfg=mcfg)
    torch.cuda.synchronize()
    secs["par_train_meshless"] = time.perf_counter() - t
    # the meshless run against itself: K2 and the projection's backward
    # add gradients with atomics, so two runs part in the last bits from
    # the second step, and Adam's normalised steps carry that on
    spread = np.max([rel_steps(run_optim(
        copy_state(state), gt, w2c, Ks, PAR_STEPS, tcfg,
        enable_pruning=True, mcfg=mcfg)[1], losses1)
        for _ in range(PAR_REPEATS)], axis=0)
    loss_tol = max(PAR_LOSS_RTOL, 2 * float(spread.max()))
    set_launches(0)
    t = time.perf_counter()
    st_m, losses_m = run_optim(copy_state(state), gt, w2c, Ks, PAR_STEPS,
                               tcfg, enable_pruning=True, mcfg=mcfg,
                               mesh=mesh)
    torch.cuda.synchronize()
    secs["par_train_mesh"] = time.perf_counter() - t
    launches = read_launches()
    rel = rel_steps(losses_m, losses1)
    print(f"[parallel] run_optim(mesh=), {PAR_STEPS} steps with one MCMC "
          f"refine, {state.params['means'].shape[0]} Gaussian slots: "
          f"{secs['par_train_mesh']:.3f} s (meshless "
          f"{secs['par_train_meshless']:.3f} s); losses within "
          f"{rel.max():.3g} relative of the meshless run's (first step "
          f"{rel[0]:.3g}, limit {PAR_FIRST_RTOL}; limit {loss_tol:.3g}: "
          f"{PAR_LOSS_RTOL} or twice the meshless run's own spread over "
          f"{PAR_REPEATS} repeats, "
          f"{spread.max():.3g}), last {losses_m[-1]:.6f}; n_alive "
          f"{st_m.n_alive}; launches {launches}", flush=True)
    print(f"[parallel] per step, relative: the meshless repeats against it "
          f"{np.round(spread, 7).tolist()}; the mesh's against it "
          f"{np.round(rel, 7).tolist()}", flush=True)
    check(rel[0] <= PAR_FIRST_RTOL, f"sharded first loss off by {rel[0]}")
    check(rel.max() <= loss_tol, f"sharded losses off by {rel.max()}")
    check(all(bool(torch.isfinite(v).all()) for v in st_m.params.values()),
          "sharded training left non-finite parameters")
    for name in ("composite_fwd_packed", "composite_bwd_packed"):
        check(launches[name] == PAR_STEPS,
              f"run_optim(mesh=) launched {name} {launches[name]} times")
    check(launches["gather_entries"] == 0,
          "run_optim(mesh=) launched the standalone gather")

    t = time.perf_counter()
    polish1 = par_polish(dev)
    check_polish("world 1", par_polish(dev, mesh), polish1)
    secs["par_polish"] = time.perf_counter() - t
    dist.destroy_process_group()
    secs["parallel_world1"] = time.perf_counter() - t0

    # (b): two ranks on the one card over gloo
    t = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    for rank in range(2):
        log = open(os.path.join(work_dir, f"par_rank{rank}.log"), "w")
        logs.append(log)
        call = (f"parallel_rank({rank}, {work_dir!r}, {str(dev)!r}, "
                f"{model.cfg.name!r}, {views[0].shape[-1]})")
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke, sys; sys.exit(chip_smoke.{call})"],
            cwd=here, env={**os.environ, "PYTHONPATH": here}, stdout=log,
            stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=PAR_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for rank, rc in enumerate(rcs):
        if rc != 0:
            with open(os.path.join(work_dir, f"par_rank{rank}.log")) as f:
                print(f.read()[-6000:], file=sys.stderr)
        check(rc == 0, f"[parallel] rank {rank} of 2 exited {rc}")
    secs["parallel_world2"] = time.perf_counter() - t
    outs = []
    for rank in range(2):
        with open(os.path.join(work_dir, f"par_rank{rank}.json")) as f:
            outs.append(json.load(f))
    o = outs[0]
    check(outs[1]["losses"] == o["losses"],
          "the two ranks' losses differ")
    tol = {k: max(2 * o["bf16_err"][k], PAR_TP_FLOOR) for k in o["tp_err"]}
    print(f"[parallel] world 2 (gloo, both ranks on {dev}): tensor-parallel"
          f" forward (model axis 2) of {o['batch']} pairs, scaled "
          f"difference from the meshless bfloat16 forward "
          f"{ {k: float(f'{v:.3g}') for k, v in o['tp_err'].items()} }, "
          f"limit twice the meshless bfloat16 forward's own from float32, "
          f"at least {PAR_TP_FLOOR}: "
          f"{ {k: float(f'{v:.3g}') for k, v in tol.items()} }; "
          f"{o['n_split']} parameters split; forward {o['tp_fwd_s']:.3f} s "
          f"(meshless {o['fwd_s']:.3f} s)", flush=True)
    for k, v in o["tp_err"].items():
        check(v <= tol[k], f"tensor-parallel {k} off by {v} (> {tol[k]})")
    rel2 = rel_steps(o["losses"], losses1)
    print(f"[parallel] world 2: run_optim(mesh=) {PAR_STEPS} steps in "
          f"{o['train_s']:.3f} s (three cameras a rank), losses within "
          f"{rel2.max():.3g} relative of (a)'s meshless run (first step "
          f"{rel2[0]:.3g}, limit {PAR_FIRST_RTOL}; limit {loss_tol:.3g}); "
          f"per step {np.round(rel2, 7).tolist()}; launches per rank "
          f"{o['launches']}", flush=True)
    check(rel2[0] <= PAR_FIRST_RTOL, f"world-2 first loss off by {rel2[0]}")
    check(rel2.max() <= loss_tol, f"world-2 losses off by {rel2.max()}")
    for name in ("composite_fwd_packed", "composite_bwd_packed"):
        check(o["launches"][name] == PAR_STEPS,
              f"rank 0 launched {name} {o['launches'][name]} times")
    check(o["finite"], "world-2 training left non-finite parameters")
    check_polish("world 2", {k: (np.asarray(v[0]), v[1])
                             for k, v in o["polish"].items()}, polish1)
    return secs, launches


def parallel_rank(rank, work_dir, device, preset, hw):
    """One of `[parallel]`'s two ranks on ``device`` (both on the one card)
    over gloo, with the ``preset`` model on ``hw`` px views; writes
    par_rank<rank>.json into ``work_dir``. Returns the exit code."""
    import torch
    import torch.distributed as dist
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import starst3r_tpu_torch as stt
    from starst3r_tpu_torch.imaging import make_pair_indices
    from starst3r_tpu_torch.parallel import (initialize_distributed,
                                             make_mesh, tp_param_specs,
                                             tp_shard_params)
    from starst3r_tpu_torch.splat.train import AdamState, GSState, run_optim
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"file://{work_dir}/store", 2, rank,
                           backend="gloo", device=device)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}

    model = stt.Mast3rModel.init_random(stt.model_preset(preset), seed=0,
                                        device=dev)
    tp = tp_shard_params(model, make_mesh(data=1, model=2))
    out["n_split"] = sum("model" in tuple(s)
                         for s in tp_param_specs(model).values())
    pairs = make_pair_indices(N_VIEWS, symmetric=True)[:8]
    imgs = torch.as_tensor(np.stack(make_views(N_VIEWS, hw)), device=dev)
    imgs = imgs.permute(0, 2, 3, 1).contiguous()
    img1 = imgs[[p[0] for p in pairs]]
    img2 = imgs[[p[1] for p in pairs]]
    out["batch"] = len(pairs)
    model.infer_pair_batch(img1, img2)
    sync()
    t = time.perf_counter()
    ref = model.infer_pair_batch(img1, img2)
    sync()
    out["fwd_s"] = time.perf_counter() - t
    with torch.inference_mode():
        f32 = model.net(img1, img2)
    tp.infer_pair_batch(img1, img2)
    sync()
    t = time.perf_counter()
    got = tp.infer_pair_batch(img1, img2)
    sync()
    out["tp_fwd_s"] = time.perf_counter() - t
    out["tp_err"] = {k: scaled_err(got[k], ref[k]) for k in ref}
    out["bf16_err"] = {k: scaled_err(ref[k], f32[k]) for k in ref}
    del model, tp, ref, f32, got, imgs, img1, img2
    torch.cuda.empty_cache()

    blob = torch.load(os.path.join(work_dir, "par_state.pt"),
                      weights_only=False)
    gen = torch.Generator(device=dev)
    gen.set_state(blob["generator"])
    to = lambda d: {k: v.to(dev) for k, v in d.items()}
    state = GSState(params=to(blob["params"]),
                    opt_state=AdamState(blob["count"], to(blob["mu"]),
                                        to(blob["nu"])),
                    step=blob["step"], generator=gen,
                    n_alive=blob["n_alive"])
    set_launches(0)
    t = time.perf_counter()
    st, losses = run_optim(state, blob["gt"], blob["w2c"], blob["Ks"],
                           blob["steps"], blob["cfg"], enable_pruning=True,
                           mcfg=blob["mcfg"], mesh=make_mesh())
    sync()
    out["train_s"] = time.perf_counter() - t
    out["launches"] = read_launches()
    out["losses"] = losses
    out["finite"] = all(bool(torch.isfinite(v).all())
                        for v in st.params.values())
    del st, state
    torch.cuda.empty_cache()

    polish = par_polish(dev, make_mesh())
    out["polish"] = {k: (v[0].tolist(), v[1]) for k, v in polish.items()}
    with open(os.path.join(work_dir, f"par_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def k2_margin(case, x, g_rgb, g_alpha, top=16, max_tiles=4):
    """`[k2-margin]`: which of K2 and the plain backward is off where they
    disagree most on the trained scene. The entries of the largest scaled
    |K2 - plain| errors (entries route, in at most ``max_tiles`` tiles)
    have their tiles' gradients recomputed by float64 autograd through
    `composite_tiles_plain` (the same early-exit mask). Where that
    gradient is 0 and the plain float32 one is not, the float32 culls
    passed on rounding noise (sigma of a near-degenerate conic);
    elsewhere K2's and the plain backward's errors against it, scaled by
    the plain gradient's largest magnitude per attribute as the gate is,
    say which is off. Returns those errors and the count of each kind of
    entry."""
    import torch
    from starst3r_tpu_torch.splat import composite as comp
    got, want, done = case["got"], case["want"], case["done"]
    c, t_total, k, _ = got.shape
    done = done.reshape(c, t_total)
    scale = want.abs().amax(dim=(0, 1, 2)).clamp(min=1e-12)
    err = ((got - want).abs() / scale).reshape(-1)
    worst = torch.topk(err, top).indices.tolist()
    at = [(w // (t_total * k * 9), (w // (k * 9)) % t_total, (w // 9) % k,
           w % 9) for w in worst]
    tiles = list(dict.fromkeys((ci, ti) for ci, ti, _, _ in at))[:max_tiles]
    h, w, tile, tw, th = geometry(x)
    out = {"k2_vs_f64": 0.0, "plain_vs_f64": 0.0, "entries_f64": 0,
           "entries_culled_in_f64": 0}
    for ci, ti in tiles:
        counts = torch.zeros_like(x["counts"][ci:ci + 1])
        counts[0, ti] = x["counts"][ci, ti]
        e = x["entries"][ci:ci + 1].double().requires_grad_(True)
        with torch.enable_grad():
            rgb, alpha = comp.composite_tiles_plain(e, counts, h, w, tile,
                                                    tw, th)
            (ref,) = torch.autograd.grad(
                (rgb, alpha), e, (g_rgb[ci:ci + 1].double(),
                                  g_alpha[ci:ci + 1].double()))
        reached = (torch.arange(k, device=e.device)
                   < int(done[ci, ti]) * comp.BATCH)
        ref = ref[0, ti] * reached[:, None]
        vals = []
        for cc, tt, slot, a in at:
            if (cc, tt) != (ci, ti):
                continue
            g, pl = float(got[ci, ti, slot, a]), float(want[ci, ti, slot, a])
            r, s_a = float(ref[slot, a]), float(scale[a])
            if r == 0.0 and pl != 0.0:
                out["entries_culled_in_f64"] += 1
            else:
                out["entries_f64"] += 1
                out["k2_vs_f64"] = max(out["k2_vs_f64"], abs(g - r) / s_a)
                out["plain_vs_f64"] = max(out["plain_vs_f64"],
                                          abs(pl - r) / s_a)
            vals.append(f"slot {slot} attribute {a}: K2 {g:.7g}, plain "
                        f"{pl:.7g}, float64 {r:.7g}")
        print(f"[k2-margin] camera {ci} tile {ti} ({int(counts[0, ti])} "
              f"entries, done {int(done[ci, ti])}): " + "; ".join(vals[:4]),
              flush=True)
    print(f"[k2-margin] the {top} largest scaled |K2 - plain| errors "
          f"(largest {float(err.max()):.3e}, gate {BWD_SCALED_TOL}; the "
          "plain gradient's largest magnitude per attribute "
          f"{[f'{v:.3g}' for v in scale.tolist()]}), in {len(tiles)} tiles:"
          f" at {out['entries_culled_in_f64']} entries the float64 "
          "gradient is 0 (the float32 culls passed on rounding noise); at "
          f"the other {out['entries_f64']} the scaled error against float64"
          f" is K2 {out['k2_vs_f64']:.3e}, plain {out['plain_vs_f64']:.3e}",
          flush=True)
    return out


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

    # the pair cache and the checkpoints; removed at the end (and, after a
    # failed check, when the interpreter exits)
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    cache_dir = os.path.join(work.name, "pairs")

    # slice 1: reconstruct and render
    set_launches(0)
    scene, orig, novel, secs = drive_main_path(stt, model, views, dev,
                                               N_NOVEL, cache_dir)
    render_launches = read_launches()
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
    check(render_launches["composite_fwd_packed"] > 0,
          "the renders did not launch the packed forward kernel")
    check(render_launches["gather_entries"] == 0,
          "the renders launched the standalone gather")
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
    for name in ("composite_fwd_packed", "composite_bwd_packed"):
        check(train_launches[name] > 0, f"training did not launch {name}")
    check(train_launches["gather_entries"] == 0
          and after_launches["gather_entries"] == 0,
          "training or the renders after it launched the standalone gather")
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
    margin = k2_margin(bwd_cases[1], real["x"], real["g_rgb"],
                       real["g_alpha"])
    for key in ("got", "want", "done"):
        del bwd_cases[1][key]
    gather = check_gather_kernel(real)
    fused = fused_phase(render_in, real, dev)
    if args.parent_csrc:
        side_by_side(args.parent_csrc, render_in, real)

    # slice 7: the sharded paths on the trained scene, held to the
    # meshless runs (before slice 5's register_camera adds a seventh view)
    del real, render_in
    torch.cuda.empty_cache()
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_par_") as par_dir:
        seven, par_launches = parallel_phase(stt, model, views, scene, dev,
                                             par_dir)
    seven["parallel"] = time.perf_counter() - t
    print("[stages] slice 7: " + " ".join(f"{k}={v:.3f}s"
                                          for k, v in seven.items()),
          flush=True)

    # slice 5: checkpoints of the trained scene and the model, a held-out
    # camera registered against the scene, the polished reconstructions
    torch.cuda.empty_cache()
    more = checkpoint_phase(stt, model, scene, work.name)
    more.update(register_phase(model, scene))
    more.update(polish_phase(stt, model, views, dev, cache_dir))
    print("[stages] slice 5: " + " ".join(f"{k}={v:.3f}s"
                                          for k, v in more.items()),
          flush=True)

    # slice 6: the command line, the GA on planted cameras, the turntable
    torch.cuda.empty_cache()
    six = cli_phase(stt, views, os.path.join(work.name, "model.npz"),
                    work.name)
    work.cleanup()
    six.update(planted_ga_phase(dev))
    six.update(turntable_phase())
    print("[stages] slice 6: " + " ".join(f"{k}={v:.3f}s"
                                          for k, v in six.items())
          + "; k2-margin: " + " ".join(f"{k}={v:.3g}"
                                       for k, v in margin.items()),
          flush=True)

    kernels_line = []
    # K1's and K2's rows are their packed routes, the functions the main
    # path launches. composite_bwd's error is the scaled one its tolerance
    # is stated in: per attribute, max |kernel - plain| over the plain
    # version's largest magnitude (the conic gradients of the trained scene
    # reach 1e11). The gather's row is the standalone kernel, which the main
    # path no longer launches.
    rows = (("composite_fwd", "composite_fwd_packed",
             "starst3r_tpu/splat/pallas_composite.py:107", fwd_cases[0],
             max(c["max_abs_err"] for c in fwd_cases), None),
            ("composite_bwd", "composite_bwd_packed",
             "starst3r_tpu/splat/pallas_composite.py:159", bwd_cases[0],
             max(c["scaled_err"] for c in bwd_cases), None),
            ("gather_entries", "gather_entries",
             "tools/probe_mosaic_gather.py:69", gather,
             gather["max_abs_err"], gather["library_ms"]))
    for name, function, replaces, case, err, library_ms in rows:
        bound_ms, bound_by = bound(case["bytes"], case["ops"])
        walked_ms, _ = bound(case["bytes"], case.get("ops_walked", 0))
        pairs = case.get("pairs", {})
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": f"starst3r_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": train_launches[function],
            "launches_parallel": par_launches[function],
            "max_abs_err": err, "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "function": function, "ms_events": case.get("ms_events"),
            "bytes_sector": case.get("bytes_sector", case["bytes"]),
            "bound_ms_walked": walked_ms,
            "pairs_walked": pairs.get("walked"),
            "pairs_in_boxes": pairs.get("in_boxes"),
            "pairs_passing": pairs.get("passing")})
        print(f"[kernel] {name} ({function}): {case['ms']:.4f} ms, plain "
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
