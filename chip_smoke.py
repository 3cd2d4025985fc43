#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`starst3r_tpu_torch`) end to end on one
NVIDIA GPU and hold its CUDA kernels against their plain versions.

    python3 chip_smoke.py [--parent-csrc DIR] [--res512-record PATH]

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
     every kernel's launch count set to 0 just before and read just after
     (MASt3R's attention kernel launched enc_depth + 4 dec_depth times
     for each of the forwards add_images ran, counted at
     `Mast3rModel.infer_pair_batch`, and never elsewhere);
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
     ``packed[gidx]``. The packed route's parts are timed apart (K2 with
     the zero fill of its per-slot gradient, the CSR of the binning's
     indices, the row-sum kernel that sums each table row's slots in a
     fixed order) beside the packed K2 with float atomics that this
     route replaced (K2_ATOMIC_MS), each with its bound; the row sum's
     table is held bit for bit to `_gather_rows_bwd_in_order` of K2's
     per-slot gradient and to a second launch;
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
     the packed backward (K2's per-slot gradient and the row sum; within
     1e-6 per attribute);
     and one training step on each route (the same state and bins): its
     peak device memory and, under torch.profiler, its device-busy time;
  8. with --parent-csrc, the compositing kernels of another revision of
     starst3r_tpu_torch/csrc (a parent commit's, unpacked with git
     archive), built with the same nvcc line, held to these and timed
     beside them in turns on the render's and the trained scene's entries;
     and its row-gather backward (its `gather_rows_bwd` export), right
     after step 18, held to this one and timed beside it in turns (parent,
     new, new, parent) at both of step 18's operating points (the GA's
     step on the card no longer launches it);
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
     where a subcommand renders or trains, the attention kernel's as in
     step 2 for each subcommand; the images loaded through the
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
     for 50 steps with one MCMC refine, K1, K2 and the row sum launched
     50 times each, its losses against the meshless run's (the first
     step's to 1e-6; the rest to 2e-4 or twice the meshless run's
     distance from two runs whose start was moved one ulp, up and down;
     a second meshless run from the unmoved start must give the same
     bits); the sharded LM and Schur polish on the planted problem. (b)
     Two ranks on the one card over
     gloo, each its own interpreter (`parallel_rank`): the large model's
     tensor-parallel forward (model axis 2) of 8 pairs against the
     meshless bfloat16 forward (at most twice that forward's own distance
     from float32), the same 50 training steps (K1 and K2 launched 50
     times a rank) against (a)'s meshless losses, and the polish. Its
     seconds are on a `[stages] slice 7:` line;
 17. `[ga-graph]` (run after step 2): the GA's captured step against the
     same step run eagerly, on the condensed data of step 2's first
     add_images call with the GA cut to 100 + 50 steps (as `[parallel]`
     cuts it), in turns (eager, graph, eager, graph): each route's seconds
     per phase, the graph route's captures, replays and host reads (one
     capture a phase, a replay a step, ceil(niter / jit_chunk) reads a
     phase), and the graph route's poses in the root camera's frame, K and
     depth, each scaled by its largest magnitude, within twice the two
     eager runs' distance from each other (never below 1e-6), as
     tests/test_torch_cuda.py holds them; then the fused loss
     (`ga_loss_report`: the kernel in each phase against the losses'
     autograd chain within GA_LOSS_TOL and against its order in PyTorch,
     two launches bit for bit, its device ms beside its bound and the
     chain's kernels' device ms), the step's kernels (`ga_step_report`:
     `ga_reparam` and `ga_update` against their order in PyTorch on the
     card within GA_STEP_IN_ORDER_TOL, bit for bit reported, each one's
     device ms beside its bound), and one replayed coarse step
     (`replay_report`: ms by CUDA events over 50 replays, device-busy ms,
     the kernels one replay launches by the profiler's kernel events, at
     most STEP_MAX_KERNELS) and its five costliest kernels. Step 2 itself
     checks that its two GA calls captured 4 steps, replayed 2 x 700 and
     read the host 2 x (10 + 4) times, and that they called the fused loss
     and the step (`ga_step.ga_step_cuda`) as often as the counters can
     see, once in each of each phase's three warm-up steps and its capture
     (16), and launched the row-gather backward never. Its seconds are on a
     `[stages] slice 8:` line;
 18. `[ga-gather]` (run after step 2, before `[ga-graph]`): the
     row-sum kernel (`ops/row_sum.py`) against its plain version
     (``index_add_``, summed in float64) on the card, at each of the JAX
     GA's six gather sites' shapes on two GAStates: the first add_images
     call's condensed data and the JAX package's 512 px operating point
     (`[ga-512]`'s scene), with their indices' CSR and a seeded
     cotangent: within 1e-5 (1 + max|plain|), equal bit for bit to
     `_gather_rows_bwd_in_order` (the kernel's summation order in
     PyTorch), empty rows exactly 0, two launches equal bit for bit, a
     launch replayed in a CUDA graph equal to the eager one; each site's
     kernel time, launch shape and blocks (at most that many SMs), the
     library call ``zeros(R, D).index_add_(0, idx, ct)`` (float32), the
     autograd backward of ``table[idx]``, the plain version and the
     bound. The `kernels` line's `gather_rows_bwd` row sums the main
     path's six sites (`at_512px` the other six). Its seconds are on a
     `[stages] slice 10:` line;
 19. `[ga-512]` (after `[ga-graph]`): run_global_alignment at the JAX
     package's 512 px operating point
     (tests/test_ga_groundtruth.py::test_ga_512px_scale_memory: 10
     cameras, 4,096 core points, 368,640 correspondences, GA 50 + 20 at
     jit_chunk 10): finite poses, the graph route's counts, the fused
     loss's and the step's calls (8 each: each phase's warm-up steps and
     capture) and no row-gather backward launch; the GA's seconds, the
     ATE, the fused loss, the step's kernels and one replayed coarse step
     as `[ga-graph]` reports them, and the same reports at the recon
     cells' condensed shapes (six views of 224 x 160 and 512 x 384,
     tests/torch_ga_scene.py::condensed_case).
     Its seconds are on the `[stages] slice 10:` line;
 20. `[res512]` (after step 15, on the same model): the main path on 4:3
     photos at the checkpoint's 512 px: six 640 x 480 PNGs of
     make_views' scene through load_images(size=512) on the native route
     ((3, 384, 512) each), Scene.add_images(4) and add_images(2) at the
     default GA (500 + 200) with conf_thres 1.0, init_3dgs (more dense
     points than SplatConfig.cap_max, so the pool is the points and MCMC
     growth is inert: N, the pool and cap_max printed and checked),
     render_3dgs_original(512, 384) and 8 path views, run_3dgs_optim with
     MCMC for RES_STEPS steps (the main phase's refines at 100 and 150,
     cut in depth only), the renders again. Checks: the shapes, finite
     orthonormal poses, every principal point nearer (256, 192) than
     (192, 256), finite dense points no more than 6 x 512 x 384, finite
     losses whose last RES_WINDOW fall below their first, n_alive within
     the pool and as gsplat's rule says, no non-finite value out of the
     packed backward, K1 and K2 launched, and the fused loss called 16
     times where the counter sees it and the row-gather backward never
     during the GA, and the attention kernel's launches (as on the main
     path).
     Then the packed forward on the renders' inputs against its plain
     version (within ATOL) and equal to the entries route bit for bit;
     the packed backward on the trained scene against its plain version
     run one camera at a time (within BWD_SCALED_TOL, scaled; the plain
     backward of six such cameras at once would hold several times the
     memory) and within 1e-6 (scaled) of the entries route's index_add_
     (`[fused]`'s gate), its parts timed as step 5 times them; the
     row-gather backward at the six sites of the first GA call
     (`[ga-gather]`'s gates); each kernel's and its plain
     version's times beside its bound; the seconds per stage (a
     `[stages] slice 12:` line), the ms per training step (host clock,
     and CUDA events per stage), the peak device memory per stage,
     tile_overflow and n_tiles_clipped. With --res512-record PATH the
     phase's two GA calls (inputs and results) are written to PATH for
     tools/res512_ga_against_jax.py.
 21. `[repeat]` (after step 4, and in step 20 after its training): the
     main path's training repeated twice from its trained state,
     run_optim for REPEAT_STEPS steps at 224 px (one MCMC refine among
     them) and REPEAT_RES_STEPS at 512 x 384: the two runs' losses,
     parameters and Adam moments equal bit for bit, and the row sum
     launched once per K2 launch; then, at 224 px, one training step
     with a refine under torch.use_deterministic_algorithms(True,
     warn_only=True), whose warnings name every operation PyTorch knows
     as non-deterministic on the card (printed, not checked), and the
     refine's categorical draw at the pool's size three times from one
     generator state, by torch.multinomial's default route (printed) and
     by `splat.mcmc.sample_targets` (the same bits, checked).

 22. `[vggt]` (after `[ga-512]`; on its own: `python -c "import
     chip_smoke; chip_smoke.vggt_phase()"`): VGGT-1B on random weights
     (`VGGTModel.init_random`, 1,190,596,120 parameters) on the normal
     path: 32 640 x 480 PNGs of make_views' scene through
     load_images(mode="crop") (518 x 392 each), Scene.add_images (one
     forward, the fused attention route launched 24 + 2 x 24 times, the
     dense clean-up over the 32 views), init_3dgs and 2 training steps,
     then the CLI in process (`reconstruct --preset vggt_1b --gs-iters
     2`). Checks: finite orthonormal poses, finite positive focals, the
     principal points at (259, 196), finite dense points, finite losses.
     Prints each stage's seconds and the peak device memory of
     add_images, the forward's ms at 32 views (CUDA events, `cuda_ms`: a
     forward queues more launches than the queue behind `device_ms`'s
     spin holds), the fused attention's alone at 33,312 tokens (16 heads
     of 64, bfloat16; `device_ms`) with its TFLOP/s and its share of the
     forward (x 24), and the stages' seconds on a `[stages] vggt:` line.

 23. `[rope-attn]` (after `[model]`; on its own: `python -c "import
     chip_smoke; chip_smoke.attention_phase()"`): MASt3R's attention kernel
     (`csrc/rope_attention.cu`, `ops/attention.py::rope_attention`) at
     the recon cells' calls (ATTN_CASES: the encoder's self-attention and
     the decoder's self- and cross-attention at 512 x 384 and 224 x 160,
     q, k, v as the blocks' projections lay them out, the decoder's cross
     case with the key side's table from another grid): held to float64
     attention on the same rotated bfloat16 q and k (apply_rope_2d on the
     card, which the kernel's rotation equals bit for bit), no farther from
     it than twice the plain version (`apply_rope_2d` then `sdpa`, which
     rounds the scores to bfloat16) plus 1e-3 of its largest magnitude, and
     finite; its ms (`device_ms`) beside its bound (the larger of 4 B H Tq
     Tk D operations at 989 TFLOP/s and its bytes at 3.35 TB/s), the plain
     version's and `library_ms` (`apply_rope_2d`'s rotation, then
     PyTorch's `F.scaled_dot_product_attention`, timed as a yardstick
     only). Then the large network at 512 x 384 and 224 x 160, 8 pairs a
     forward: the kernel's launches in one forward (enc_depth + 4
     dec_depth, 72) and the encoder's and the decoder's ms (CUDA events).
     Each MASt3R call also times q and k rotated once then the kernel
     with no tables (`once_ms`), the route calls from ROTATE_ONCE_KEYS
     keys take, and checks that it does not take it. Then Fast3R's fusion
     call (FUSION_CASE: 64 views' 49,152 tokens, 16 heads; q at
     FUSION_Q_GAIN): the rotation kernel (`rope_rotate`,
     `ops/attention.py::rope_rotate_qk`) bit for bit
     `ops/rope.py::rope_rotate` of q and k, its ms beside its bound (its
     bytes at 3.35 TB/s) and the plain rotation's; `rope_attention` one
     rotation and one attention launch, bit for bit the kernel with its
     tables, within FUSION_TOL of the largest value of float32 attention
     (a head at a time, blocks of queries), while the kernel on unrotated
     q and k must land outside it; its ms rotated once, with its tables,
     and the kernel alone. Then Fast3R ViT-L/512 at FAST3R_VIEWS views,
     its counts zeroed before one forward: enc_depth + dec_depth (48)
     attention launches and dec_depth (24) rotations. The kernels' rows
     on the `kernels` line take their launches from step 2 (the rotation's
     0; its Fast3R count is `launches_fast3r`); the attention's row holds
     the fusion call under `cases`.

Each kernel's bound counts the work the run's data needs: for the
compositing kernels the (pixel, entry) pairs inside the entries' cull
boxes, each entry's box, and the pairs that pass the culls
(`bound_ms`); the same over every pair of the batches walked is
`bound_ms_walked`, the figure kernels that walk every pair are held to.
The compositing kernels' rows on the `kernels` line are their packed
routes, the ones the main path launches: their bytes count each entry
walked as its 4-byte index and its 36-byte row (and, for the backward,
36 bytes stored at its slot per entry that contributed), and
`bytes_sector` counts each row as the two 32-byte sectors it spans. A
kernel's `ms` (and `library_ms`) is device time per call: CUDA events
around a loop of calls queued behind a spin kernel that holds the stream
until the host has queued them all (`device_ms`), so every kernel the call
launches counts (the packed backward's: its zero fill, the CSR and the row
sum) and the host's launch pace does not; `ms_events` beside it is the
CUDA-event time per call of the same loop unqueued, which counts the pace
too; `plain_ms` is CUDA-event time, except the row-gather backward's: its
plain version is its library call (`index_add_`), timed once by
`device_ms` for both fields. torch.profiler only breaks times down and
sums a training step's device-busy time; where its trace holds no device
time those figures read "not measured" and nothing fails.

It prints the per-stage seconds, the Gaussian and coverage counts, the
training line, a line `{"kernels": [...]}` and, last,
`{"ok": true, "device": {...}}`. Any failed check exits non-zero before that
last line. Without a CUDA card, or outside a checkout of the repository, it
exits non-zero and prints no result.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# the meshless run's spread under float noise where that is larger. The
# meshless training has no float atomics, so a run from the same state
# gives the same bits (checked), and the noise is made on purpose:
# PAR_REPEATS runs from the start with every float parameter moved one
# ulp (up, then down), each one's largest relative distance from the
# unmoved run per step (the sharded runs sum the same gradients over the
# ranks in another order, and Adam's normalised steps carry such noise
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
# `[blender]`: the add-on's subprocess against the same flags through the
# CLI in process, poses in camera 0's frame (translation over the
# trajectory scale, rotation entries): `[parallel]`'s limit for two
# reconstructions of one scene
BLENDER_POSE_TOL = PAR_GA_TOL
# `[ga-graph]`: the GA's steps (cut as `[parallel]` cuts them) and the floor
# of its tolerance, the graph route against the eager step
GRAPH_GA = (100, 50)
GRAPH_GA_FLOOR = 1e-6
GA_COUNTERS = ("captures", "replays", "host_reads")
# a GA step on the card calls the fused loss (`ga_loss.ga_loss_cuda`: the
# losses and their gradient, two kernel launches) once, and the row-gather
# backward never (the losses' gathers are inside the fused loss). Under a
# CUDA graph the counter sees each phase's warm-up steps and capture, not
# the replays
LOSS_CALLS_PER_STEP = 1
# the fused loss against the autograd chain on the card
# (tests/test_torch_cuda.py's bound) and against its order in PyTorch
GA_LOSS_TOL = 1e-4
GA_LOSS_IN_ORDER_TOL = 1e-6
# the GA step's kernels against their order in PyTorch on the card
# (tests/test_torch_cuda.py's bound: libdevice's transcendentals at
# -fmad=false against PyTorch's)
GA_STEP_IN_ORDER_TOL = 1e-6
# the recon cells' condensed shapes (h, w): six views, 30 pairs
GA_LOSS_SHAPES = ((160, 224), (384, 512))
# `[ga-gather]`: the kernel against index_add_ summed in float64 (float32
# sums of up to tens of thousands of terms)
GATHER_TOL = 1e-5
# `[ga-512]`: the JAX package's 512 px GA operating point
# (tests/test_ga_groundtruth.py::test_ga_512px_scale_memory): 10 cameras,
# S = 4,096 core points, 368,640 anchored correspondences
GA512_SCENE = dict(n_cams=10, hw=512, focal=720.0, subsample=8,
                   anchored=True, orbit=True, sph_r=1.2, spread=0.2)
GA512_CFG = dict(niter1=50, niter2=20, jit_chunk=10)
# `[res512]`: the main path on six 4:3 photos (640 x 480 PNGs of
# make_views' scene) through load_images at the checkpoint's 512 px, which
# gives 512 x 384 views; training cut in depth only, to the refines at 100
# and 150 of the main phase's schedule; the losses' first and last
# RES_WINDOW steps compared
RES_PHOTO_HW = (480, 640)
RES_SIZE = 512
RES_HW = (384, 512)
RES_STEPS = 150
RES_WINDOW = 10
# `[repeat]`: the training steps repeated from the trained state, at 224 px
# and at 512 x 384
REPEAT_STEPS = 50
REPEAT_RES_STEPS = 20
# the packed K2 before its gradient was summed by the row sum: float
# atomic adds into a zero-filled (C*N, 9) table, the fill included, as an
# earlier revision measured it on an NVIDIA H100 80GB HBM3 at 700 W on
# MASt3R's attention calls in the recon cells: (name, B, (grid h, grid w),
# heads, self or cross); B is 8 pairs' 16 images in the encoder, 8 in each
# decoder stream; heads of 64
ATTN_CASES = (("512 encoder", 16, (24, 32), 16, "self"),
              ("512 decoder self", 8, (24, 32), 12, "self"),
              ("512 decoder cross", 8, (24, 32), 12, "cross"),
              ("224 encoder", 16, (10, 14), 16, "self"),
              ("224 decoder self", 8, (10, 14), 12, "self"),
              ("224 decoder cross", 8, (10, 14), 12, "cross"))
PEAK_BF16 = 989e12
# Fast3R's fusion call at 64 views of 512 x 384: (views, heads), and the
# views of the Fast3R forward whose launches `[rope-attn]` counts
FUSION_CASE = (64, 16)
FAST3R_VIEWS = 8
# the fusion call against float32 attention: within this share of the
# largest value (tests/test_torch_cuda.py's FUSED_ATTN_TOL), and q at
# this gain over unit variance, so that attention over 49,152 keys is
# far from uniform and a call that skips the rotation lands far outside
FUSION_TOL = 8e-3
FUSION_Q_GAIN = 4.0
# the kernel against float64 attention on the same rotated inputs: no
# farther than twice the plain version plus this share of the largest value
ATTN_SLACK = 1e-3
# these scenes (ms): the figures the new route's parts are printed beside
K2_ATOMIC_MS = {"224 px": 0.1873, "512 x 384": 0.5196}
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
    port's processed (3, h, w) images in [-1, 1]. ``hw`` is (h, w), or one
    int for square views; the focal is 0.8 w and the principal point the
    image centre (the 224 px views are the same for 224 and (224, 224))."""
    h, w = (hw, hw) if np.ndim(hw) == 0 else hw
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
        img = np.full((h, w, 3), 0.12, np.float32)
        f = w * 0.8
        u = (f * p[:, 0] / p[:, 2] + w / 2).astype(int)
        v = (f * p[:, 1] / p[:, 2] + h / 2).astype(int)
        ok = (u >= 1) & (u < w - 1) & (v >= 1) & (v < h - 1)
        far_first = np.argsort(-p[:, 2])
        ok = ok[far_first]
        uu, vv, cc = u[far_first][ok], v[far_first][ok], cols[far_first][ok]
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                img[vv + dv, uu + du] = cc
        views.append(np.ascontiguousarray(
            (img * 2.0 - 1.0).transpose(2, 0, 1)))
    return views


def timed_stage(secs, peak, device, name, fn):
    """Run ``fn`` as stage ``name``: its host seconds into ``secs`` and, on
    the card, the most device memory allocated during it into ``peak``.
    Returns what ``fn`` returns."""
    import torch
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    out = fn()
    if on_card:
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated(device)
    secs[name] = time.perf_counter() - t
    return out


def drive_main_path(stt, model, views, device, n_novel, cache_dir):
    """The serving half of the README Quickstart on the (3, h, w) views
    (the renders at their size). Returns the scene, the renders, the host
    seconds per stage and the peak device memory per stage."""
    import torch
    from starst3r_tpu_torch.utils.metrics import MetricsLogger

    logger = MetricsLogger()
    scene = stt.Scene(cache_dir=cache_dir, device=device, logger=logger)
    secs, peak = {}, {}

    def stage(name, fn):
        return timed_stage(secs, peak, device, name, fn)

    def add_images():
        # random weights' confidences carry no information: keep every
        # pixel that survives the cross-view cleaning (conf 1 marks the
        # rejected), so the renders see a point cloud of full size
        scene.add_images(model, views[:4], conf_thres=1.0)
        scene.add_images(model, views[4:], conf_thres=1.0)

    stage("add_images", add_images)
    for rec in logger.records:
        for name in ("inference", "matching", "canonical", "condense", "ga"):
            secs[name] = secs.get(name, 0.0) + rec[name]
    stage("init_3dgs", scene.init_3dgs)
    h, w = scene.imgs[0].shape[:2]
    orig = stage("render_original", lambda: scene.render_3dgs_original(w, h))
    path = stt.interp_se3_path(scene.c2w[0], scene.c2w[-1], n_novel)
    w2c = torch.linalg.inv(path)
    Ks = np.repeat(scene.intrinsics[:1], n_novel, 0)
    novel = stage("render_novel", lambda: scene.render_3dgs(w2c, Ks, w, h))
    return scene, orig, novel, secs, peak


def check_outputs(scene, orig, novel, n_views, hw, n_novel):
    """Finite orthonormal poses, finite intrinsics and points, and renders
    of (n, h, w) in range and not empty; ``hw`` is (h, w) or one int."""
    import torch
    h, w = (hw, hw) if np.ndim(hw) == 0 else hw
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
        check(tuple(rgb.shape) == (n, h, w, 3), f"rgb {tuple(rgb.shape)}")
        check(tuple(alpha.shape) == (n, h, w, 1),
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


def bwd_work(x, done):
    """The packed backward's bound inputs on ``x``, in the batches ``done``
    says the forward processed: bytes (reads: the entries walked, index
    and row, counts and done, T_fin, rgb and the two pixel gradients;
    writes: 36 bytes at its slot per entry that contributed, the other
    slots being the caller's zeros), bytes
    counted in 32-byte sectors, operations in the cull boxes and over
    every pair walked, and the pair counts."""
    counts = x["counts"]
    h, w, tile, tw, th = geometry(x)
    c, t = counts.shape
    p = tile * tile
    pairs = pair_counts(x["entries"], counts, done, tile, tw, th)
    fixed = c * t * 8 + c * t * p * 4 + c * h * w * (12 + 12 + 4)
    n_walked, n_added = pairs["entries"], pairs["contributing"]
    out = {"bytes": (n_walked * (INDEX_BYTES + ROW_BYTES) + fixed
                     + n_added * ROW_BYTES),
           "bytes_sector": (n_walked * (INDEX_BYTES + ROW_SECTOR_BYTES)
                            + fixed + n_added * ROW_SECTOR_BYTES),
           "pairs": pairs}
    out["ops"], out["ops_walked"] = work(pairs, BWD_PASS_OPS)
    return out


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


def render_case_inputs(scene, dev):
    """The compositing input of a render of the scene's own cameras at the
    scene's budgets (`render_3dgs_original`'s)."""
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
    return case_inputs(packed, gidx, valid, counts, h, w, tile, tw, th)


def check_composite_kernel(stt, scene, dev):
    """composite_fwd, both routes, on the real render's inputs and on the
    two small scenes. Returns the timed packed case of the render and the
    render's inputs."""
    render_in = render_case_inputs(scene, dev)
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
    """{exported kernel function: the wrapper that counts its launches (the
    fused loss's calls, two kernels each; the GA step's calls, its
    `ga_reparam`, the fused loss and `ga_update`; MASt3R's attention's
    calls and its long calls' rotations, CPU ones too)}."""
    from starst3r_tpu_torch.alignment import ga_loss, ga_step
    from starst3r_tpu_torch.ops import attention, row_sum
    from starst3r_tpu_torch.splat import composite as comp, gather as gat
    return {"ga_loss": ga_loss.ga_loss_cuda,
            "ga_step": ga_step.ga_step_cuda,
            "rope_attention": attention.rope_attention,
            "rope_rotate": attention.rope_rotate_qk,
            "composite_fwd_packed": comp.composite_packed_cuda,
            "composite_bwd_packed": comp.composite_packed_slots_cuda,
            "composite_fwd": comp.composite_tiles_cuda,
            "composite_bwd": comp.composite_tiles_bwd_cuda,
            "gather_entries": gat.gather_entries_cuda,
            "gather_rows_bwd": row_sum.gather_rows_bwd_cuda}


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


@contextlib.contextmanager
def counted_forwards():
    """MASt3R's network forwards inside the block: yields a list that gets
    one entry (the batch) for each `Mast3rModel.infer_pair_batch` call."""
    from starst3r_tpu_torch.models.mast3r import Mast3rModel
    calls, infer = [], Mast3rModel.infer_pair_batch

    def counted(self, img1, img2):
        calls.append(img1.shape[0])
        return infer(self, img1, img2)

    Mast3rModel.infer_pair_batch = counted
    try:
        yield calls
    finally:
        Mast3rModel.infer_pair_batch = infer


def check_attention_launches(launches, forwards, cfg, where):
    """Every forward in ``forwards`` launched MASt3R's attention kernel
    once a block (enc_depth + 4 dec_depth), nothing else did, and none
    launched the rotation kernel."""
    want = (cfg.enc_depth + 4 * cfg.dec_depth) * len(forwards)
    print(f"[{where}] attention kernel launches {launches['rope_attention']}"
          f" over {len(forwards)} forwards of {forwards} pairs (want {want})",
          flush=True)
    check(launches["rope_attention"] == want, f"[{where}] the attention "
          f"kernel launched {launches['rope_attention']} times over "
          f"{len(forwards)} forwards, want {want}")
    check(launches["rope_rotate"] == 0, f"[{where}] MASt3R's forwards "
          f"launched the rotation kernel {launches['rope_rotate']} times")


def read_nonfinite():
    from starst3r_tpu_torch.splat import composite as comp, gather as gat
    return {"composite_bwd_packed": int(comp.CompositePacked.nonfinite),
            "composite_bwd": int(comp.CompositeTiles.nonfinite),
            "gather_backward": int(gat.GatherEntries.nonfinite)}


def drive_training(stt, scene, n_novel, steps=TRAIN_STEPS):
    """The training path: Scene.run_3dgs_optim for ``steps`` steps with
    MCMC pruning, then the original and novel views again. Returns the losses, the loop's host
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
    losses = scene.run_3dgs_optim(steps, enable_pruning=True)
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
    route, the whole backward a training step launches (K2's per-slot
    gradient, the CSR and the row sum); grad_entries (C, T, K, 9) on the
    entries route."""
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
    tile, tw, th = geometry(x)[2:]
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
        # on the packed route the whole backward a training step launches
        # (`packed_bwd_parts` times K2, the CSR and the row sum apart)
        kernel = lambda: run_bwd(x, route, fwd_out, g_rgb, g_alpha)
        out.update(bwd_work(x, done))
        out["ms"] = device_ms(kernel, reps=20)
        out["ms_events"] = cuda_ms(kernel, reps=20)
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


def packed_bwd_parts(x, fwd_out, g_rgb, g_alpha, label):
    """The packed backward's parts on input ``x`` (the forward's outputs
    ``fwd_out``, the pixel gradients): K2 with the zero fill of its
    per-slot gradient, the CSR of the binning's indices (`packed_csr`),
    the row sum of the slots into the table (`gather_rows_bwd_cuda`), and
    the whole backward, each by `device_ms`, printed beside the atomic
    K2's time at ``label`` (K2_ATOMIC_MS, an earlier revision's figure:
    printed, never returned). The row sum's table must equal
    `_gather_rows_bwd_in_order` of the per-slot gradient, a second launch
    and the whole backward bit for bit, and the float64 ``index_add_`` of
    the slots within GATHER_TOL (1 + max). Returns the times, and the row
    sum's case for the kernels line."""
    import torch
    from starst3r_tpu_torch.ops import row_sum
    from starst3r_tpu_torch.splat import composite as comp
    rgb, _, tfin, done = fwd_out
    args = (x["packed"], x["gidx"], x["counts"], rgb, tfin, done, g_rgb,
            g_alpha, *geometry(x))
    rows, m = x["packed"].shape[0], x["gidx"].numel()
    flat = x["gidx"].reshape(-1)
    slots = comp.composite_packed_slots_cuda(*args)
    csr = comp.packed_csr(x["gidx"], x["counts"], rows)
    table = row_sum.gather_rows_bwd_cuda(slots, *csr)
    again = row_sum.gather_rows_bwd_cuda(slots, *csr)
    whole = comp.composite_packed_bwd_cuda(*args)
    in_order = row_sum._gather_rows_bwd_in_order(slots, *csr)
    # the slots past the counts are K2's zeros: index_add_ of every slot
    # is the library call, and in float64 the plain version
    want = torch.zeros((rows, 9), dtype=torch.float64,
                       device=slots.device).index_add_(0, flat,
                                                       slots.double())
    torch.cuda.synchronize()
    n_valid = int(csr[1][-1])
    tag = f"[k2-parts] {label}"
    check(n_valid == int(x["counts"].long().sum()), f"{tag}: the CSR holds "
          f"{n_valid} slots")
    check(torch.equal(table, in_order), f"{tag}: the row sum differs from "
          "its summation order in PyTorch")
    check(torch.equal(table, again), f"{tag}: two row-sum launches differ")
    check(torch.equal(table, whole), f"{tag}: the whole backward differs "
          "from its parts")
    err = float((table.double() - want).abs().max())
    tol = GATHER_TOL * (1 + float(want.abs().max()))
    check(err <= tol, f"{tag}: max|row sum - index_add_| = {err} (limit "
          f"{tol})")
    del in_order, want, whole, again, table
    k2_ms = device_ms(lambda: comp.composite_packed_slots_cuda(*args),
                      reps=20)
    csr_ms = device_ms(lambda: comp.packed_csr(x["gidx"], x["counts"],
                                               rows), reps=20)
    sum_ms = device_ms(lambda: row_sum.gather_rows_bwd_cuda(slots, *csr),
                       reps=50)
    whole_ms = device_ms(lambda: comp.composite_packed_bwd_cuda(*args),
                         reps=20)
    lib_ms = device_ms(lambda: torch.zeros(
        (rows, 9), device=slots.device).index_add_(0, flat, slots), reps=20)
    # the row sum reads each valid slot's 36 bytes and 4-byte order entry
    # and the offsets, and writes the table; one add per element. The CSR
    # reads gidx and the counts and writes order and the offsets (a sort
    # does no float operation). The fill writes the per-slot gradient
    sum_bytes = n_valid * (ROW_BYTES + INDEX_BYTES) + 4 * (rows + 1) \
        + ROW_BYTES * rows
    csr_bytes = 4 * m + 4 * x["counts"].numel() + 4 * m + 4 * (rows + 1)
    fill_bytes = ROW_BYTES * m
    plan = row_sum._gather_plan(m, rows, 9)
    out = {"k2_ms": k2_ms, "csr_ms": csr_ms, "row_sum_ms": sum_ms,
           "backward_ms": whole_ms,
           "csr_bound_ms": bound(csr_bytes, 0)[0],
           "fill_bound_ms": bound(fill_bytes, 0)[0],
           "slots": m, "valid_slots": n_valid, "rows": rows,
           "slot_bytes": fill_bytes,
           "row_sum": {"bytes": sum_bytes, "ops": 9 * n_valid, "ms": sum_ms,
                       "plain_ms": lib_ms, "library_ms": lib_ms,
                       "max_abs_err": err, "plan": plan._asdict()}}
    print(f"{tag}: K2 with the zero fill of its per-slot gradient "
          f"{k2_ms:.4f} ms ({fill_bytes} B filled, bound of the fill alone "
          f"{out['fill_bound_ms']:.4f} ms); the CSR {csr_ms:.4f} ms ({m} "
          f"slots sorted, {n_valid} valid; bound {out['csr_bound_ms']:.4f}"
          f" ms, bytes); the row sum {sum_ms:.4f} ms ({n_valid} slots into "
          f"{rows} rows of 9, plan {tuple(plan)}; bound "
          f"{bound(sum_bytes, 9 * n_valid)[0]:.4f} ms, bytes; the library "
          f"call zeros + index_add_ {lib_ms:.4f} ms); the whole backward "
          f"{whole_ms:.4f} ms against {K2_ATOMIC_MS[label]} ms for the "
          f"atomic K2 with its table fill (an earlier revision's, NVIDIA "
          f"H100 80GB HBM3 at 700 W); the row sum's table equals its order "
          f"in PyTorch, a second launch and the whole backward bit for "
          f"bit, max|row sum - float64 index_add_| = {err:.3g} (limit "
          f"{tol:.3g})", flush=True)
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
    # the row sum: the packed backward's, or the standalone gather's
    check(launched["fused"]["gather_entries"] == 0
          and launched["fused"]["composite_bwd_packed"] == 1
          and launched["fused"]["gather_rows_bwd"] == 1,
          f"[fused] the packed step launched {launched['fused']}")
    check(launched["unfused"]["gather_entries"] == 1
          and launched["unfused"]["composite_bwd"] == 1
          and launched["unfused"]["gather_rows_bwd"] == 1,
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
    from starst3r_tpu_torch import kernels

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
    before it. Returns (rc, seconds, launches, the network's forwards)."""
    import torch
    set_launches(0)
    t = time.perf_counter()
    with counted_forwards() as forwards:
        rc = cli.main(args)
    torch.cuda.synchronize()
    return rc, time.perf_counter() - t, read_launches(), forwards


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
        secs, launches, forwards = {}, {}, {}
        for name, args in runs.items():
            rc, secs[name], launches[name], forwards[name] = cli_run(cli,
                                                                     args)
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
        check_attention_launches(got, forwards[name],
                                 stt.ModelConfig.large(), f"cli {name}")
    check(len(forwards["reconstruct"]) > 0, "cli reconstruct ran no forward")

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


def pose_gap(got, want):
    """(translation error over the trajectory scale, rotation error) of
    two runs' poses, each camera in camera 0's frame."""
    a, b = relative_poses(got), relative_poses(want)
    scale = max(traj_scale(b), 1e-12)
    return (float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max()) / scale,
            float(np.abs(a[:, :3, :3] - b[:, :3, :3]).max()))


def blender_phase(model_npz, work_dir):
    """`[blender]`: the add-on for the port (blender_addon_torch) the way
    its operator runs it: the command built by its bpy-free `command.py`
    from the panel's values (the six views' PNG directory of `[cli]`, that
    phase's model file, preset large, resolution 224, device cuda), run as
    a subprocess, its output read with `read_result`. Held against the same
    flags through the CLI in process (`cli.main`), the `[cli]` phase's
    entry; `[cli]`'s own reconstruct fed the views 4 + 2 and trained 50
    steps, so its poses are another computation, and their distance is
    printed only. Returns the seconds."""
    import torch
    from starst3r_tpu_torch import cli
    from blender_addon_torch import command

    imgdir = os.path.join(work_dir, "cli", "views")
    out = os.path.join(work_dir, "blender", "out")
    ref_out = os.path.join(work_dir, "blender", "in_process")
    check(command.verify(imgdir, model_npz) is None,
          f"the add-on refuses its inputs: {command.verify(imgdir, model_npz)}")
    cmd = command.build_command(sys.executable, imgdir, out, HW, "large",
                                "cuda", model_npz)
    here = os.path.dirname(os.path.abspath(__file__))
    secs = {}
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=here, check=False)
    secs["blender_subprocess"] = time.perf_counter() - t
    check(proc.returncode == 0, f"the add-on's command exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    pts, cols, c2w = command.read_result(out)
    n = pts.shape[0]
    check(pts.ndim == 2 and pts.shape[1] == 3 and np.isfinite(pts).all(),
          f"points.ply: shape {pts.shape}, finite {np.isfinite(pts).all()}")
    check(cols is not None and cols.shape == (n, 3)
          and bool(((cols >= 0) & (cols <= 1)).all()),
          "points.ply's colours")
    check(c2w is not None and c2w.shape == (N_VIEWS, 4, 4)
          and np.isfinite(c2w).all(),
          f"c2w.npy: {None if c2w is None else c2w.shape}")
    args = cmd[3:]          # the flags after `python -m starst3r_tpu_torch`
    args[args.index("--out") + 1] = ref_out
    # this script turns TF32 off for its checks; the subprocess has
    # PyTorch's defaults (cuBLAS float32 matmuls in full precision, cuDNN
    # convolutions in TF32), and so has the in-process run
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    t = time.perf_counter()
    try:
        rc = cli.main(args)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    secs["blender_in_process"] = time.perf_counter() - t
    check(rc == 0, f"the in-process CLI with the add-on's flags exited {rc}")
    ref_pts, _, ref_c2w = command.read_result(ref_out)
    same = bool(np.array_equal(c2w, ref_c2w) and np.array_equal(pts, ref_pts))
    t_err, r_err = pose_gap(c2w, ref_c2w)
    why = ("bit for bit: the same flags, weights and images, and a GA with "
           "no atomics" if same else "the two processes differ before the "
           "GA (their inference or image loading), and Adam carries it")
    print(f"[blender] {' '.join(cmd[1:5])} ... --preset large --res {HW} "
          f"(subprocess, {secs['blender_subprocess']:.3f} s): {n} points "
          f"(conf_thres 1.5, the CLI's default; [cli] passes 1.0), c2w "
          f"{c2w.shape}; against the same flags through cli.main in process "
          f"({secs['blender_in_process']:.3f} s): "
          f"{'equal' if same else 'not equal'}, poses in camera 0's frame "
          f"within {t_err:.3g} x the trajectory scale and {r_err:.3g} in "
          f"rotation (limit {BLENDER_POSE_TOL}), {ref_pts.shape[0]} points "
          f"(limit within 1%): {why}", flush=True)
    check(t_err <= BLENDER_POSE_TOL and r_err <= BLENDER_POSE_TOL,
          f"the add-on's poses differ from the in-process CLI's by "
          f"{t_err:.3g} / {r_err:.3g}")
    check(abs(ref_pts.shape[0] - n) <= 0.01 * n,
          f"the add-on's run kept {n} points, the in-process run "
          f"{ref_pts.shape[0]}")
    cli_c2w = np.load(os.path.join(work_dir, "cli", "out", "c2w.npy"))
    print(f"[blender] against [cli]'s reconstruct (views 4 + 2, 50 training "
          f"steps; another computation, printed only): poses within "
          f"{pose_gap(c2w, cli_c2w)[0]:.3g} x the trajectory scale and "
          f"{pose_gap(c2w, cli_c2w)[1]:.3g} in rotation", flush=True)
    return secs


def spellings_phase(stt, model, views, scene, cache_dir, work_dir):
    """`[spellings]`: each call the port repaired for the JAX package's
    spelling, made in that spelling on the card and held to the port's
    keyword spelling. Returns the seconds."""
    import dataclasses
    import torch
    from starst3r_tpu_torch import native
    from starst3r_tpu_torch.imaging import image_route
    from starst3r_tpu_torch.ops.attention import sdpa
    from starst3r_tpu_torch.splat import gather as gat
    from starst3r_tpu_torch.splat.rasterize import rasterize
    from starst3r_tpu_torch.splat.train import render_inputs
    from starst3r_tpu_torch.utils import compile_cache, enable_compilation_cache

    secs, notes = {}, []
    t = time.perf_counter()
    cfg = stt.default_config()
    cfg = dataclasses.replace(cfg, ga=dataclasses.replace(
        cfg.ga, niter1=PAR_GA[0], niter2=PAR_GA[1]))
    files = [f"view_{i}.png" for i in range(len(views))]
    rec_j, _ = stt.reconstruct_scene(model, views, files, "cuda",
                                     tmpdir=cache_dir, config=cfg)
    rec_k, _ = stt.reconstruct_scene(model, views, device="cuda",
                                     tmpdir=cache_dir, config=cfg)
    check(np.array_equal(rec_j.cam2w, rec_k.cam2w)
          and np.array_equal(rec_j.intrinsics, rec_k.intrinsics),
          "reconstruct_scene(model, imgs, files, 'cuda') differs from the "
          "keyword call")
    notes.append(f"reconstruct_scene(model, imgs, files, 'cuda') = keyword "
                 f"call (GA {PAR_GA[0]} + {PAR_GA[1]}, poses equal)")
    secs["spell_reconstruct"] = time.perf_counter() - t

    t = time.perf_counter()
    m2 = stt.Mast3rModel.init_random(model.cfg, 0, image_hw=(HW, HW))
    want = model.state_dict()
    check(m2.device.type == "cuda" and all(
        torch.equal(v, want[k]) for k, v in m2.state_dict().items()),
        "init_random(cfg, 0, image_hw=) is not the seed-0 model on cuda")
    del m2
    torch.cuda.empty_cache()
    notes.append("init_random(cfg, 0, image_hw=(224, 224)) on cuda, weights "
                 "= the main path's model")
    secs["spell_init_random"] = time.perf_counter() - t

    gs, scfg = scene.gs_state, scene.config.splat
    args = render_inputs(gs.params, scfg, gs.n_alive) + (
        torch.as_tensor(scene.w2c, dtype=torch.float32, device="cuda"),
        torch.as_tensor(scene.intrinsics, dtype=torch.float32,
                        device="cuda"))
    h, w = scene.imgs[0].shape[:2]
    budgets = (w, h, scfg.sh_degree, scfg.tile_size,
               scfg.max_tiles_per_gaussian, scfg.max_per_tile, scfg.chunk)
    with torch.no_grad():
        rgb_k, alpha_k, _ = rasterize(*args, *budgets)
        set_launches(0)
        rgb_j, alpha_j, _ = rasterize(*args, *budgets, "auto")
        k1 = read_launches()["composite_fwd_packed"]
    check(k1 > 0, "rasterize(impl='auto') did not launch K1")
    check(torch.equal(rgb_j, rgb_k) and torch.equal(alpha_j, alpha_k),
          "rasterize(..., 'auto') differs from the default call")
    notes.append(f"rasterize(..., chunk, 'auto') = default call on the "
                 f"trained scene ({rgb_j.shape[0]} views), K1 launched {k1}")

    q, k, v = (torch.randn(8, 196, 16, 64, generator=torch.Generator(
        "cuda").manual_seed(i), device="cuda") for i in range(3))
    for impl in ("xla", "einsum"):
        check(torch.equal(sdpa(q, k, v, impl), sdpa(q, k, v)),
              f"sdpa(impl={impl!r}) differs")
    notes.append("sdpa(q, k, v, 'xla' | 'einsum') = sdpa(q, k, v)")

    paths = sorted(os.path.join(work_dir, "cli", "views", f)
                   for f in os.listdir(os.path.join(work_dir, "cli",
                                                    "views")))
    got = stt.load_images(paths, HW, 16, "auto")
    base = stt.load_images(paths, size=HW, impl=None)
    check(all(np.array_equal(a, b) for a, b in zip(got, base)),
          "load_images(impl='auto') differs from impl=None")
    notes.append(f"load_images(paths, 224, 16, 'auto'): the "
                 f"{image_route('auto')} route, = impl=None")

    t = time.perf_counter()
    so = native._lib_path()
    before = os.stat(so).st_ino if so.exists() else None
    digest = native.hash64(b"starst3r")
    check(native.build(force=True), "native.build(force=True) failed")
    after = os.stat(so)
    check(after.st_ino != before, "native.build(force=True) did not rebuild")
    check(native.available() and native.hash64(b"starst3r") == digest,
          "the rebuilt native library did not load")
    secs["spell_native_build"] = time.perf_counter() - t
    notes.append(f"native.build(force=True) rebuilt {so.name} "
                 f"({secs['spell_native_build']:.3f} s) and loaded it")

    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as cache:
        enable_compilation_cache(cache)
        try:
            check(compile_cache.build_dir() == Path(cache).resolve(),
                  "enable_compilation_cache did not take the directory")
            gen = torch.Generator("cuda").manual_seed(0)
            packed = torch.randn(64, 9, device="cuda", generator=gen)
            gidx = torch.randint(0, 64, (4, 8), device="cuda", generator=gen,
                                 dtype=torch.int32)
            valid = torch.rand(4, 8, device="cuda", generator=gen) < 0.7
            gat.gather_entries_cuda.launches = 0
            out = gat.gather_entries_cuda(packed, gidx, valid)
            launched = gat.gather_entries_cuda.launches
            built = sorted(f for f in os.listdir(cache) if f.endswith(".so"))
        finally:
            enable_compilation_cache()
    check(launched == 1 and any(f.startswith("gather_entries_")
                                for f in built),
          f"no kernel built and launched under the cache: {built}, "
          f"{launched} launches")
    check(torch.equal(out, gat.gather_entries_plain(packed, gidx, valid)),
          "the gather built under the cache differs from its plain version")
    check(compile_cache.build_dir().name == "_build",
          "enable_compilation_cache() did not return to _build/")
    secs["spell_compile_cache"] = time.perf_counter() - t
    notes.append(f"enable_compilation_cache(tmpdir): built {built} there "
                 f"and launched it once ({secs['spell_compile_cache']:.3f} s)"
                 f", = its plain version")
    print("[spellings] " + "; ".join(notes), flush=True)
    return secs


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
    for fn in ("composite_fwd_packed", "composite_bwd_packed",
               "gather_rows_bwd", "ga_loss"):
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


def nudged_state(state, toward):
    """`copy_state` with every float parameter moved one ulp toward
    ``toward`` (inf or -inf)."""
    import torch
    st = copy_state(state)
    return st._replace(params={
        k: torch.nextafter(v, torch.full_like(v, toward))
        if v.is_floating_point() else v for k, v in st.params.items()})


def same_bits(a, b):
    """Two GSStates' parameters and Adam moments equal bit for bit."""
    import torch
    return (a.n_alive == b.n_alive
            and all(torch.equal(v, b.params[k]) for k, v in a.params.items())
            and all(torch.equal(v, b.opt_state.mu[k])
                    for k, v in a.opt_state.mu.items())
            and all(torch.equal(v, b.opt_state.nu[k])
                    for k, v in a.opt_state.nu.items()))


def repeat_phase(label, scene, steps, probe=False):
    """`[repeat]`: the main path's training (run_optim with MCMC on the
    arguments Scene.run_3dgs_optim gives it, `par_train_inputs`) run
    twice for ``steps`` steps from
    the scene's trained state: the losses, the parameters and the Adam
    moments must be equal bit for bit, and the row sum launched once per
    K2 launch. With ``probe``, one more step, a refine step, under
    torch.use_deterministic_algorithms(True, warn_only=True): the
    operations PyTorch warns of are printed. Returns the seconds."""
    import warnings
    import torch
    from starst3r_tpu_torch.splat.train import run_optim
    t0 = time.perf_counter()
    state = scene.gs_state
    *train, mcfg = par_train_inputs(scene)
    refines = [s for s in range(state.step + 1, state.step + steps + 1)
               if mcfg.refine_start <= s < mcfg.refine_stop
               and s % mcfg.refine_every == 0]
    runs = []
    for _ in range(2):
        set_launches(0)
        st, losses = run_optim(copy_state(state), *train[:3], steps,
                               train[3], enable_pruning=True, mcfg=mcfg)
        torch.cuda.synchronize()
        runs.append((st, losses, read_launches()))
    (a, la, na), (b, lb, nb) = runs
    same = la == lb and same_bits(a, b)
    print(f"[repeat] {label}: run_optim {steps} steps from the trained "
          f"state (steps {state.step + 1}-{state.step + steps}, MCMC "
          f"refines at {refines}), twice: losses, parameters and Adam "
          f"moments {'equal bit for bit' if same else 'DIFFER'}; losses "
          f"first {la[0]:.7f} last {la[-1]:.7f} / {lb[-1]:.7f}; n_alive "
          f"{a.n_alive}; launches {na}", flush=True)
    check(same, f"[repeat] {label}: two trainings from one state differ")
    check(all(np.isfinite(la)), f"[repeat] {label}: a loss is not finite")
    for n in (na, nb):
        check(n["composite_bwd_packed"] == n["gather_rows_bwd"] == steps,
              f"[repeat] {label}: launches {n}")
    del runs, a, b
    if probe:
        # a state one step before a refine: the probe's step refines
        every = mcfg.refine_every
        step = max(mcfg.refine_start, (state.step // every + 1) * every) - 1
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                run_optim(copy_state(state)._replace(step=step),
                          *train[:3], 1, train[3], enable_pruning=True,
                          mcfg=mcfg)
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        flagged = sorted({str(w.message).split("\n")[0][:240]
                          for w in caught
                          if "determinis" in str(w.message).lower()})
        print(f"[repeat] {label}: one training step with a refine (step "
              f"{step + 1}) under torch.use_deterministic_algorithms(True, "
              f"warn_only=True): {len(flagged)} operations flagged"
              + "".join(f"\n[repeat]   {m}" for m in flagged), flush=True)
        # the refine's categorical draw at the pool's size, three times
        # from one generator state: torch.multinomial as PyTorch runs it
        # by default (a float scan in no fixed order), and as
        # `sample_targets` runs it, under deterministic algorithms
        from starst3r_tpu_torch.splat.mcmc import sample_targets
        pool = state.params["means"].shape[0]
        gen = torch.Generator(device=state.generator.device).manual_seed(0)
        weights = torch.rand(pool, generator=gen, device=gen.device)
        seeded = lambda: torch.Generator(device=gen.device).manual_seed(1)
        plain = [torch.multinomial(weights, pool, replacement=True,
                                   generator=seeded()) for _ in range(3)]
        port = [sample_targets(weights, torch.ones_like(weights, dtype=bool),
                               pool, seeded()) for _ in range(3)]
        same = {name: all(torch.equal(d[0], x) for x in d[1:])
                for name, d in (("default", plain), ("port", port))}
        print(f"[repeat] {label}: {pool} categorical draws from one "
              f"generator state, three times: torch.multinomial by default "
              f"{'the same' if same['default'] else 'other'} bits; "
              f"sample_targets {'the same' if same['port'] else 'other'} "
              f"bits", flush=True)
        check(same["port"], f"[repeat] {label}: sample_targets gave other "
              "draws from one generator state")
    return time.perf_counter() - t0


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


def set_ga_counts(value=0):
    from starst3r_tpu_torch.alignment import ga
    for name in GA_COUNTERS:
        setattr(ga._optimize_phase, name, value)


def read_ga_counts():
    from starst3r_tpu_torch.alignment import ga
    return {name: getattr(ga._optimize_phase, name) for name in GA_COUNTERS}


def ga_reads(cfg):
    """The host reads of one GA call: ceil(niter / jit_chunk) a phase."""
    chunk = max(cfg.jit_chunk, 1)
    return sum(-(-n // chunk) for n in (cfg.niter1, cfg.niter2))


def eager_phase(params, state, niter, lr_base, lr_end, gamma, phase, cfg):
    """The graph route's plain version: the GA phase's step run eagerly on
    the card, with no chunks and one host read at the end."""
    from starst3r_tpu_torch.alignment import ga
    ph = ga._Phase(params, state, niter, lr_base, lr_end, gamma, phase, cfg)
    ph.steps(niter)
    return ga.GAParams(*[p.detach() for p in ph.params]), float(ph.last_loss)


def ga_errors(a, b, root):
    """Scaled differences of two GA results: poses in the root camera's
    frame (the GA's free rigid motion), K, depth, the phase losses."""
    rel = lambda m: (np.linalg.inv(m[root].astype(np.float64))[None]
                     @ m.astype(np.float64))
    out = {"cam2w": scaled_err(rel(a.cam2w.cpu().numpy()),
                               rel(b.cam2w.cpu().numpy())),
           "K": scaled_err(a.K, b.K), "depth": scaled_err(a.depth, b.depth)}
    out["loss"] = max(abs(x - y) / max(abs(y), 1e-30) for x, y in (
        (a.loss_coarse, b.loss_coarse), (a.loss_fine, b.loss_fine)))
    return out


def ga_loss_calls(cfg):
    """The fused loss's calls one GA call makes where the counter sees
    them: each phase's warm-up steps and its capture."""
    from starst3r_tpu_torch.alignment import ga
    return sum((ga._WARMUP_STEPS + 1) * LOSS_CALLS_PER_STEP
               for n in (cfg.niter1, cfg.niter2) if n)


# each JAX `_gather_rows` site's line in starst3r_tpu/alignment/ga.py
GATHER_LINES = {"depth": 346, "K": 348, "cam2w": 354, "proj": 385,
                "pair_cam2w": 405, "pair_pts3d": 411}


def gather_sites(state):
    """The six JAX `_gather_rows` sites on ``state``'s own indices: (name,
    line in starst3r_tpu/alignment/ga.py, table rows R, width D, idx, its
    CSR)."""
    from starst3r_tpu_torch.ops.row_sum import _gather_csr
    from torch_ga_scene import state_sites
    return tuple((name, GATHER_LINES[name], r, d, idx, _gather_csr(idx, r))
                 for name, (r, d, idx) in state_sites(state).items())


def site_cotangent(m, d, dev, seed=0):
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy((3.0 * rng.normal(size=(m, d))).astype(
        np.float32)).to(dev)


def ga512_inputs():
    """The JAX package's 512 px GA operating point: (data, mst, gt c2w,
    GAConfig)."""
    from starst3r_tpu_torch.config import GAConfig
    from starst3r_tpu_torch.utils.synthetic import synthetic_ga_scene
    data, mst, gt, _ = synthetic_ga_scene(**GA512_SCENE)
    return data, mst, gt, GAConfig(**GA512_CFG)


def ga_gather_phase(points, dev):
    """`[ga-gather]`: the row-gather backward kernel against its plain
    version on the card at the six JAX gather sites' shapes, on the
    GAStates of ``points`` ({name: GAState}: the main path's first GA and
    the 512 px operating point). Returns the kernels line's case (the main
    path's six sites summed), the 512 px sites' sum and the seconds."""
    import torch
    from starst3r_tpu_torch.ops import row_sum
    t0 = time.perf_counter()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    totals = {}
    for point, state in points.items():
        out = []
        for name, line, r, d, idx, csr in gather_sites(state):
            m = idx.numel()
            ct = site_cotangent(m, d, dev)
            kernel = lambda: row_sum.gather_rows_bwd_cuda(ct, *csr)
            got, again = kernel(), kernel()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = kernel()
            replayed.zero_()
            graph.replay()
            # the plain version summed in float64: float32 index_add_ adds
            # with atomics, as far from the exact sum as the kernel
            want = row_sum._gather_rows_bwd_plain(idx, ct.double(), r)
            in_order = row_sum._gather_rows_bwd_in_order(ct, *csr)
            torch.cuda.synchronize()
            err = float((got.double() - want).abs().max())
            tol = GATHER_TOL * (1 + float(want.abs().max()))
            empty = torch.bincount(idx, minlength=r) == 0
            n_empty = int(empty.sum())
            tag = f"[ga-gather] {point} {name}"
            check(err <= tol, f"{tag}: max|kernel - plain| = {err} (limit "
                  f"{tol})")
            check(torch.equal(got, in_order), f"{tag}: the kernel differs "
                  "from its summation order in PyTorch")
            check(bool((got[empty] == 0).all()), f"{tag}: an empty row is "
                  "not 0")
            check(torch.equal(got, again), f"{tag}: two launches differ")
            check(torch.equal(replayed, got), f"{tag}: the graph replay "
                  "differs from the eager launch")
            graph.reset()
            del want, in_order
            table = torch.zeros((r, d), device=dev, requires_grad=True)
            gathered = table[idx]
            # what the kernel reads and writes: the cotangent, the int32
            # row order, the int32 offsets and the output; one add per
            # cotangent element
            n_bytes = 4 * m * d + 4 * m + 4 * (r + 1) + 4 * r * d
            # the plain version is the library call, zeros + index_add_:
            # one timing fills both fields
            plain_ms = device_ms(
                lambda: row_sum._gather_rows_bwd_plain(idx, ct, r), reps=50)
            plan = row_sum._gather_plan(m, r, d)
            gx, gy = plan.grid(r, d)
            case = {
                "name": name,
                "replaces": f"starst3r_tpu/alignment/ga.py:{line}",
                "rows": r, "width": d, "entries": m, "empty_rows": n_empty,
                "max_abs_err": err, "bytes": n_bytes, "ops": m * d,
                "ms": device_ms(kernel, reps=50), "library_ms": plain_ms,
                "autograd_ms": device_ms(lambda: torch.autograd.grad(
                    gathered, table, ct, retain_graph=True), reps=50),
                "plain_ms": plain_ms, "plan": plan._asdict(),
                "blocks": gx * gy}
            case["bound_ms"] = bound(n_bytes, m * d)[0]
            out.append(case)
            print(f"{tag} (ga.py:{line}): table ({r}, {d}), {m} entries, "
                  f"{n_empty} empty rows; max|kernel - plain| = {err:.3g} "
                  f"(limit {tol:.3g}), equal to its order in PyTorch; "
                  f"kernel {case['ms']:.4f} ms, plain version (the library "
                  f"call zeros + index_add_) {plain_ms:.4f} ms, autograd "
                  f"backward of table[idx] {case['autograd_ms']:.4f} ms, "
                  f"bound {case['bound_ms']:.3g} ms ({case['ms'] / case[
                      'bound_ms']:.1f}x); {gx * gy} blocks of "
                  f"{plan.threads} threads ({gx // plan.cluster} row blocks"
                  f" x {gy} column tiles, clusters of {plan.cluster}): at "
                  f"most {min(gx * gy, n_sm)} of {n_sm} SMs; plan "
                  f"{tuple(plan)}", flush=True)
            del gathered, table
        total = {key: sum(c[key] for c in out)
                 for key in ("bytes", "ops", "ms", "library_ms",
                             "autograd_ms", "plain_ms")}
        total["max_abs_err"] = max(c["max_abs_err"] for c in out)
        total["gathers"] = out
        totals[point] = total
        print(f"[ga-gather] {point}: the six sites summed: kernel "
              f"{total['ms']:.4f} ms, plain (library) "
              f"{total['plain_ms']:.4f} ms, autograd "
              f"{total['autograd_ms']:.4f} ms, bound "
              f"{bound(total['bytes'], total['ops'])[0]:.3g} ms", flush=True)
    return totals, {"ga_gather": time.perf_counter() - t0}


# the GA's step on the card, the one route `replay_report` times: the
# step's kernels (`ga_step.ga_step_cuda`: ga_reparam, the fused loss,
# ga_update)
STEP_ROUTES = ("kernels",)
# a replayed step launches ga_reparam, the fused loss's two kernels and
# ga_update
STEP_MAX_KERNELS = 6


def replayed_step(data, mst, cfg, dev):
    """One replayed coarse step of the GA on ``data``: (ms by CUDA events
    over 50 replays, device-busy ms by torch.profiler or None, {kernel: ms
    a step}, the kernels one replay launches by the profiler's kernel
    events, or None)."""
    from starst3r_tpu_torch.alignment import ga
    ph = ga._Phase(ga.init_params(data, device=dev),
                   ga.make_state(data, mst, cfg, device=dev), cfg.niter1,
                   cfg.lr1, cfg.lr_end, cfg.gamma1, 1, cfg)
    graph = ga._capture(ph)
    step_ms = cuda_ms(graph.replay, 50)
    busy_ms, by_kernel = profiled_ms(graph.replay, 10)
    n_kernels = replay_kernels(graph)
    graph.reset()
    return step_ms, busy_ms, by_kernel, n_kernels


def replay_kernels(graph, tries=2):
    """The kernels one replay of ``graph`` launches, counted from
    torch.profiler's kernel events (copies and sets left out), or None
    when the trace holds no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if str(ev.device_type).endswith("CUDA")]
        if events:
            return sum(ev.count for ev in events
                       if not ev.key.startswith(("Memcpy", "Memset")))
    return None


def ga_loss_plain(K, cam2w, depth, proj, state, phase, gamma, alpha, cfg):
    """The losses' autograd chain (`ga._Phase.loss`, the CPU's step): the
    fused loss's plain version."""
    from starst3r_tpu_torch.alignment import ga
    if phase == 1:
        main = ga._loss_3d(K, cam2w, depth, state, gamma, alpha)
    else:
        main = ga._loss_2d(K, cam2w, depth, proj, state, gamma, alpha)
    reg = ga._loss_dust3r(ga._core_pts3d(K, cam2w, depth, state), cam2w,
                          state, cfg.gamma_d)
    return main + cfg.loss_dust3r_w * reg


def ga_loss_report(tag, data, mst, cfg, dev):
    """The fused loss (`ga_loss.ga_loss_cuda`) on ``data`` at the GA's
    start, alpha 1, in each phase: the kernel's loss and its gradients
    (K, cam2w, proj in phase 2, depth) against the autograd chain's with
    respect to the same tensors (within GA_LOSS_TOL of each gradient's
    largest magnitude) and against its order in PyTorch on the card
    (GA_LOSS_IN_ORDER_TOL; bit for bit reported), two launches bit for
    bit, its device ms (its two launches) beside its bound and the chain's
    forward and backward kernels. Returns {phase: case}."""
    import torch
    from starst3r_tpu_torch.alignment import ga, ga_loss as gl
    state = ga.make_state(data, mst, cfg, device=dev)
    K, w2c, cam2w, depth = [t.detach() for t in ga.make_K_cam_depth(
        ga.init_params(data, device=dev), state, cfg.depth_mode,
        cfg.shared_intrinsics, cfg.exp_depth)]
    alpha = torch.ones((), device=dev)
    out = {}
    for phase, gamma in ((1, cfg.gamma1), (2, cfg.gamma2)):
        fused = gl.make_loss_data(state, phase, gamma, cfg.gamma_d,
                                  cfg.loss_dust3r_w)
        proj = K @ w2c[:, :3] if phase == 2 else None
        loss, grads = gl.ga_loss_cuda(K, cam2w, depth, proj, alpha, fused)
        want_loss, want = gl.ga_loss_in_order(K, cam2w, depth, proj, alpha,
                                              fused)
        in_order = max(scaled_err(grads, want),
                       abs(float(loss) - float(want_loss))
                       / abs(float(want_loss)))
        inputs = [K, cam2w, depth] + ([proj] if phase == 2 else [])
        leaves = [t.clone().requires_grad_(True) for t in inputs]

        def plain_fn():
            return ga_loss_plain(*leaves[:3], leaves[3] if phase == 2
                                 else None, state, phase, gamma, alpha, cfg)

        def plain_grads():
            return torch.autograd.grad(plain_fn(), leaves)

        views = gl._views(grads, gl._grad_layout(*fused.dims[:2], phase))
        errs = [scaled_err(views[name], g) for name, g in zip(
            ("K", "cam2w", "depth", "proj"), plain_grads())]
        plain_loss = float(plain_fn())
        errs.append(abs(float(loss) - plain_loss) / abs(plain_loss))
        kernel_ms = device_ms(lambda: gl.ga_loss_cuda(
            K, cam2w, depth, proj, alpha, fused), reps=50)
        # the chain's hundreds of small launches: its kernels' device time
        # summed by the profiler (`device_ms`'s spin does not hold a queue
        # of them at the 512 px point)
        plain_ms, _ = profiled_ms(plain_grads, 5)
        c, s, m, p = fused.dims
        fallback = bool(fused.floats()["scal"][2] > 0)
        cams = c * (25 + (12 if phase == 2 else 0))
        # each input byte read once: a correspondence's two cameras, two
        # depth rows (int32), two pixels, two depth offsets and its weight;
        # the depth and camera tables; the fallback's targets, weights and
        # core pixels where it has weight; the gradient and the loss
        n_bytes = (44 * m + 4 * c * s + 4 * cams
                   + (16 * p * s + 8 * s if fallback else 0)
                   + 4 * (cams + c * s) + 4)
        # float32 operations, counted from the kernel's arithmetic: about
        # 90 a correspondence and side (both endpoints or the projection,
        # the distance, the gradient), 60 a (pair, point) of the fallback
        n_ops = 2 * 90 * m + (60 * p * s if fallback else 0)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        out[phase] = {"ms": kernel_ms, "plain_ms": plain_ms,
                      "library_ms": None, "bytes": n_bytes, "ops": n_ops,
                      "bound_ms": bound_ms, "max_abs_err": max(errs),
                      "in_order_err": in_order,
                      "in_order_equal": bool(torch.equal(grads, want)
                                             and torch.equal(loss,
                                                             want_loss)),
                      "plan": fused.plan._asdict(), "dims": fused.dims,
                      "fallback": fallback}
        print(f"{tag} fused loss, phase {phase} (C, S, M, P) = "
              f"{fused.dims}, fallback {'on' if fallback else 'off'}, plan "
              f"{tuple(fused.plan)}: kernel {kernel_ms:.4f} ms a step, "
              f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes} B, {n_ops} "
              f"ops; {kernel_ms / bound_ms:.1f}x), the autograd chain's "
              f"forward and backward "
              + (f"{plain_ms:.4f} ms of kernels" if plain_ms else
                 "not measured") + "; against the chain: "
              f"K, cam2w, depth, (proj,) loss {[f'{e:.3g}' for e in errs]} "
              f"(limit {GA_LOSS_TOL}); against its order in PyTorch "
              f"{in_order:.3g} (limit {GA_LOSS_IN_ORDER_TOL}), bit for bit "
              f"{out[phase]['in_order_equal']}", flush=True)
        check(max(errs) <= GA_LOSS_TOL, f"{tag} the fused loss, phase "
              f"{phase}, off the autograd chain's by {max(errs)}")
        check(in_order <= GA_LOSS_IN_ORDER_TOL, f"{tag} the fused loss, "
              f"phase {phase}, off its order in PyTorch by {in_order}")
        again = gl.ga_loss_cuda(K, cam2w, depth, proj, alpha, fused)
        check(torch.equal(again[0], loss) and torch.equal(again[1], grads),
              f"{tag} two launches of the fused loss differ")
    return out


def replay_report(tag, data, mst, cfg, dev):
    """One replayed coarse step: ms a step, device-busy ms and the kernels
    one replay launches, at most STEP_MAX_KERNELS where the profiler
    counts them. Returns (ms, busy, {kernel: ms}) and {route: (ms, busy,
    kernels)}."""
    routes = {route: replayed_step(data, mst, cfg, dev)
              for route in STEP_ROUTES}
    for name, (step_ms, busy_ms, by_kernel, n) in routes.items():
        print(f"{tag} a replayed coarse step, {name}: {step_ms:.4f} ms "
              f"(CUDA events over 50 replays); torch.profiler: "
              + (f"{busy_ms:.4f} ms device busy, {len(by_kernel)} kernel "
                 f"names, {n} kernels launched in one replay" if busy_ms
                 else "no device events (not measured)"), flush=True)
    n = routes[STEP_ROUTES[0]][3]
    check(n is None or n <= STEP_MAX_KERNELS, f"{tag} a replayed step "
          f"launched {n} kernels, want at most {STEP_MAX_KERNELS}")
    return routes[STEP_ROUTES[0]][:3], {
        k: (v[0], v[1], v[3]) for k, v in routes.items()}


def ga_step_report(tag, data, mst, cfg, dev):
    """The GA step's two kernels (`ga_step.ga_reparam_cuda`,
    `ga_update_cuda`) on ``data`` at the GA's start, in each phase: each
    against its order in PyTorch on the card (fed the same fused loss's
    output), and each one's device ms beside its bound. Returns {phase:
    case}."""
    import torch
    from starst3r_tpu_torch.alignment import ga, ga_step as gs
    from starst3r_tpu_torch.alignment.ga_loss import ga_loss_cuda
    state = ga.make_state(data, mst, cfg, device=dev)
    out = {}
    for phase, gamma, lr in ((1, cfg.gamma1, cfg.lr1),
                             (2, cfg.gamma2, cfg.lr2)):
        ph = ga._Phase(ga.init_params(data, device=dev), state, cfg.niter1,
                       lr, cfg.lr_end, gamma, phase, cfg)
        sd = ph.step_data
        old = [t.detach().clone() for t in ph.tensors()]
        got = [t.clone() for t in old]
        buf = gs.step_buffer(sd)
        gs.ga_reparam_cuda(got[:6], got[18], buf, sd)
        loss, grads = ga_loss_cuda(*gs.loss_inputs(buf, sd), ph.loss_data)
        fwd = {k: v.clone() for k, v in gs.fwd_views(buf, sd).items()}
        gs.ga_update_cuda(got, loss, grads, buf, sd)
        want_fwd = gs.reparam_in_order(old[:6], old[18], sd)
        want = gs.update_in_order(old, loss, grads, fwd, sd)
        errs = [scaled_err(fwd[k], w) for k, w in want_fwd.items()]
        # the moments (the params' first update is +-lr by a gradient's
        # sign, the root camera's gauge included)
        errs += [scaled_err(g, w) for g, w in zip(got[6:18], want[6:18])]
        equal = all(bool(torch.equal(fwd[k], w))
                    for k, w in want_fwd.items()) and all(
            bool(torch.equal(g, w)) for g, w in zip(got, want))
        state_now = [t.clone() for t in old]
        reparam_ms = device_ms(lambda: gs.ga_reparam_cuda(
            state_now[:6], state_now[18], buf, sd), reps=50)
        update_ms = device_ms(lambda: gs.ga_update_cuda(
            state_now, loss, grads, buf, sd), reps=50)
        c, s, k = sd.dims
        leaves = 11 * c + c * (k or s)
        cam_out = (9 + 16 + 16 + 12 + 24) * c
        # each byte read once and each written once: reparam reads the
        # leaves and statics (the lora basis) and writes the cameras, the
        # depth and the core values; update reads the fused loss's
        # gradient, the core values, the leaves and moments, and writes
        # the leaves and moments
        r_bytes = 4 * (leaves + 8 * c + c * s * k + cam_out + 2 * c * s)
        u_bytes = 4 * (grads.numel() + c * s + 3 * leaves + 3 * leaves
                       + (c * s * k if k else 0))
        r_bound, _ = bound(r_bytes, 0)
        u_bound, _ = bound(u_bytes, 0)
        out[phase] = {"reparam_ms": reparam_ms, "update_ms": update_ms,
                      "reparam_bytes": r_bytes, "update_bytes": u_bytes,
                      "reparam_bound_ms": r_bound,
                      "update_bound_ms": u_bound,
                      "in_order_err": max(errs), "in_order_equal": equal,
                      "dims": sd.dims}
        print(f"{tag} step kernels, phase {phase} (C, S, k) = {sd.dims}: "
              f"ga_reparam {reparam_ms:.4f} ms (bound {r_bound:.5f} ms, "
              f"bytes: {r_bytes} B), ga_update {update_ms:.4f} ms (bound "
              f"{u_bound:.5f} ms, bytes: {u_bytes} B); against their order "
              f"in PyTorch "
              f"{max(errs):.3g} (limit {GA_STEP_IN_ORDER_TOL}), bit for "
              f"bit {equal}", flush=True)
        check(max(errs) <= GA_STEP_IN_ORDER_TOL, f"{tag} the step's "
              f"kernels, phase {phase}, off their order in PyTorch by "
              f"{max(errs)}")
    return out


def step_row(cases, shapes):
    """The `kernels` line's case of the GA step's kernels: phase 1 at the
    main path's first GA call (both kernels' ms and bytes; no plain
    version runs on the card), the rest as they are."""
    one = cases[1]
    return {"ms": one["reparam_ms"] + one["update_ms"], "plain_ms": None,
            "bytes": one["reparam_bytes"] + one["update_bytes"], "ops": 0,
            "phase1": one, "phase2": cases[2], "replay": cases["replay"],
            "at_shapes": shapes}


def ga512_phase(dev):
    """`[ga-512]`: run_global_alignment at the JAX package's 512 px
    operating point (tests/test_ga_groundtruth.py::
    test_ga_512px_scale_memory's scene and GAConfig) on the card: finite
    poses, the graph route's counts, the row-gather backward's launches
    (each phase's warm-up steps and capture); the GA's seconds, the ATE,
    one replayed coarse step's time and kernels,
    and the step's kernels (`ga_step_report`), here and at the recon cells'
    condensed shapes. Returns (the seconds, the fused loss's cases, the
    step's cases)."""
    import torch
    from starst3r_tpu_torch.alignment import ga
    from starst3r_tpu_torch.utils.eval import ate_rmse
    data, mst, gt, cfg = ga512_inputs()
    set_ga_counts(0)
    before = read_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res, _ = ga.run_global_alignment(data, mst, cfg, device=dev)
    pred = res.cam2w.cpu().numpy()
    secs = time.perf_counter() - t
    after = read_launches()
    launches, g1, steps = (after[k] - before[k] for k in (
        "ga_loss", "gather_rows_bwd", "ga_step"))
    counts = read_ga_counts()
    ate, scale = ate_rmse(pred, gt), traj_scale(gt)
    want = {"captures": 2, "replays": cfg.niter1 + cfg.niter2,
            "host_reads": ga_reads(cfg)}
    print(f"[ga-512] {data.pps.shape[0]} cameras, "
          f"{len(data.corr_idx1)} correspondences, "
          f"{data.core_pix.shape[0]} core points, GA {cfg.niter1} + "
          f"{cfg.niter2}, jit_chunk {cfg.jit_chunk}: {secs:.3f} s; losses "
          f"({res.loss_coarse}, {res.loss_fine}); ATE {ate:.6g} = "
          f"{ate / scale:.6g} x the trajectory scale; fused loss calls "
          f"{launches} (want {ga_loss_calls(cfg)}), gather_rows_bwd "
          f"launches {g1} (want 0); counts {counts} (want {want})",
          flush=True)
    check(np.isfinite(pred).all(), "[ga-512] poses not finite")
    check(counts == want, f"[ga-512] counts {counts}, want {want}")
    check(launches == ga_loss_calls(cfg) and g1 == 0
          and steps == ga_loss_calls(cfg),
          f"[ga-512] {launches} fused loss calls, {g1} row-gather "
          f"backward launches and {steps} GA step calls, want "
          f"{ga_loss_calls(cfg)}, 0 and {ga_loss_calls(cfg)}")
    ga_loss_report("[ga-512]", data, mst, cfg, dev)
    step_shapes = {"512px": ga_step_report("[ga-512]", data, mst, cfg,
                                           dev)}
    (_, _, by_kernel), step_shapes["512px"]["replay"] = replay_report(
        "[ga-512]", data, mst, cfg, dev)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]:
        print(f"[ga-512]   {ms:8.4f} ms/step  {name[:100]}", flush=True)
    # the recon cells' condensed shapes: six views, 30 pairs, S
    # correspondences a pair (tests/torch_ga_scene.py::condensed_case)
    from torch_ga_scene import condensed_case
    shapes = {}
    for h, w in GA_LOSS_SHAPES:
        c_data, c_mst = condensed_case(h, w)
        shapes[f"{w}x{h}"] = ga_loss_report(f"[ga-512] {w}x{h} views:",
                                            c_data, c_mst, cfg, dev)
        tag = f"[ga-512] {w}x{h} views:"
        step_shapes[f"{w}x{h}"] = ga_step_report(tag, c_data, c_mst, cfg,
                                                 dev)
        step_shapes[f"{w}x{h}"]["replay"] = replay_report(
            tag, c_data, c_mst, cfg, dev)[1]
    return {"ga_512": secs}, shapes, step_shapes


def parent_rows_bwd(parent_csrc):
    """The parent revision's row-gather backward (its `gather_rows_bwd`
    export: one block a row, its shape chosen in C) as a stand-in for
    `row_sum.gather_rows_bwd_cuda`, counting its own launches; None where
    the parent's source has no such export."""
    import torch
    from starst3r_tpu_torch import kernels
    fn = getattr(kernels.library("gather_rows_bwd", parent_csrc),
                 "gather_rows_bwd", None)
    if fn is None:
        return None

    def run(ct, order, offsets):
        rows, (m, width) = offsets.numel() - 1, ct.shape
        d = torch.empty((rows, width), dtype=torch.float32,
                        device=ct.device)
        err = fn(ct.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                 d.data_ptr(), rows, width, m,
                 torch.cuda.current_stream(ct.device).cuda_stream)
        check(err == 0, f"the parent's gather_rows_bwd: CUDA error {err}")
        run.launches += 1
        return d

    run.launches = 0
    return run


def ga_side_by_side(parent_csrc, points, dev):
    """The parent's row-gather backward (built from ``parent_csrc``) and
    this one in one process, in turns (parent, new, new, parent): each
    gather site at both operating points (the outputs within GATHER_TOL
    of each other: two summation orders). The GA's step on the card no
    longer launches it (the fused loss holds the gathers), so only the
    sites are compared."""
    import torch
    from starst3r_tpu_torch.ops import row_sum
    parent = parent_rows_bwd(parent_csrc)
    if parent is None:
        print("[side-by-side] the parent's source has no gather_rows_bwd: "
              "the GA's row gather is not compared", flush=True)
        return
    routes = {"parent": parent, "new": row_sum.gather_rows_bwd_cuda}
    turns = ("parent", "new", "new", "parent")
    for point, state in points.items():
        sums = {side: 0.0 for side in routes}
        for name, _, r, d, idx, csr in gather_sites(state):
            ct = site_cotangent(idx.numel(), d, dev)
            a, b = parent(ct, *csr), routes["new"](ct, *csr)
            torch.cuda.synchronize()
            diff = float((a - b).abs().max())
            tol = GATHER_TOL * (1 + float(a.abs().max()))
            check(diff <= tol, f"[side-by-side] {point} {name}: the new "
                  f"row-gather backward is {diff} from the parent's")
            ms = {side: [] for side in routes}
            for side in turns:
                ms[side].append(device_ms(
                    lambda: routes[side](ct, *csr), reps=50))
            for side in routes:
                sums[side] += float(np.mean(ms[side]))
            print(f"[side-by-side] gather_rows_bwd {point} {name}: parent "
                  f"{np.mean(ms['parent']):.4f} ms {ms['parent']}, new "
                  f"{np.mean(ms['new']):.4f} ms {ms['new']}; max |new - "
                  f"parent| {diff:.3g}", flush=True)
        print(f"[side-by-side] gather_rows_bwd {point}, the six sites "
              f"summed: parent {sums['parent']:.4f} ms, new "
              f"{sums['new']:.4f} ms", flush=True)

    check(parent.launches > 0, "[side-by-side] the parent's row-gather "
          "backward was never launched")


def ga_graph_phase(call, dev):
    """`[ga-graph]`: the GA of ``call`` (the arguments of the main path's
    first GA) cut to GRAPH_GA steps, on the graph route and with the eager
    step, in turns. Returns the seconds."""
    import dataclasses
    import torch
    from starst3r_tpu_torch.alignment import ga
    (data, mst, cfg), kw, _ = call
    cfg = dataclasses.replace(cfg, niter1=GRAPH_GA[0], niter2=GRAPH_GA[1])
    real_phase = ga._optimize_phase
    runs = []
    for route in ("eager", "graph", "eager", "graph"):
        phase_s = []

        def timed(*a, _fn=real_phase if route == "graph" else eager_phase):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*a)
            torch.cuda.synchronize()
            phase_s.append(time.perf_counter() - t)
            return out

        # the timer shares the counters of the function it times
        timed.__dict__ = real_phase.__dict__
        ga._optimize_phase = timed
        set_ga_counts(0)
        try:
            res, _ = ga.run_global_alignment(data, mst, cfg, **kw)
        finally:
            ga._optimize_phase = real_phase
        runs.append((route, res, phase_s, read_ga_counts()))
    (_, eager_a, eager_s, eager_counts), (_, graph_a, graph_s, counts) = \
        runs[:2]
    eager_b, graph_b = runs[2][1], runs[3][1]
    root = mst[0]
    spread = ga_errors(eager_b, eager_a, root)
    got = ga_errors(graph_a, eager_a, root)
    again = ga_errors(graph_b, graph_a, root)
    want = {"captures": 2, "replays": sum(GRAPH_GA),
            "host_reads": ga_reads(cfg)}
    fmt = lambda d: " ".join(f"{k}={v:.3g}" for k, v in d.items())
    print(f"[ga-graph] first add_images call's data ({data.pps.shape[0]} "
          f"cameras, {len(data.corr_idx1)} correspondences, "
          f"{data.core_pix.shape[0]} core points), GA {GRAPH_GA[0]} + "
          f"{GRAPH_GA[1]}, jit_chunk {cfg.jit_chunk}: seconds per phase, "
          f"graph {[round(x, 4) for x in graph_s]} then "
          f"{[round(x, 4) for x in runs[3][2]]}, eager step "
          f"{[round(x, 4) for x in eager_s]} then "
          f"{[round(x, 4) for x in runs[2][2]]}; graph route counts "
          f"{counts} (want {want}; eager {eager_counts})", flush=True)
    print(f"[ga-graph] scaled differences: graph against eager {fmt(got)}; "
          f"eager against eager {fmt(spread)}; graph against graph "
          f"{fmt(again)}; losses graph ({graph_a.loss_coarse}, "
          f"{graph_a.loss_fine}) eager ({eager_a.loss_coarse}, "
          f"{eager_a.loss_fine})", flush=True)
    check(counts == want, f"[ga-graph] counts {counts}, want {want}")
    check(eager_counts["captures"] == 0 and eager_counts["replays"] == 0,
          f"the eager step captured or replayed: {eager_counts}")
    check(np.isfinite(graph_a.cam2w.cpu().numpy()).all(),
          "[ga-graph] poses not finite")
    for name, err in got.items():
        tol = max(2 * spread[name], GRAPH_GA_FLOOR)
        check(err <= tol, f"[ga-graph] {name} off the eager step's by "
              f"{err} (limit {tol})")

    # the fused loss at this data (checked against the autograd chain);
    # the step's kernels; one replayed coarse step's time, its kernels and
    # its launches, on a phase captured from the same data at the GA's
    # start (reported, not checked); where the profiler's
    # device-busy time matches it, the step is device-bound
    loss_cases = ga_loss_report("[ga-graph]", data, mst, cfg, dev)
    step_cases = ga_step_report("[ga-graph]", data, mst, cfg, dev)
    (_, _, by_kernel), step_cases["replay"] = replay_report(
        "[ga-graph]", data, mst, cfg, dev)
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]:
        print(f"[ga-graph]   {ms:8.4f} ms/step  {name[:100]}", flush=True)
    return ({"ga_graph": sum(graph_s), "ga_eager": sum(eager_s)},
            loss_cases, step_cases)


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
    st1, losses1 = run_optim(copy_state(state), gt, w2c, Ks, PAR_STEPS,
                             tcfg, enable_pruning=True, mcfg=mcfg)
    torch.cuda.synchronize()
    secs["par_train_meshless"] = time.perf_counter() - t
    # the meshless run again from the same state: the same bits (no float
    # atomics on the step); the limit's noise yardstick is the spread of
    # PAR_REPEATS runs whose start moved one ulp, up and down
    st_r, losses_r = run_optim(copy_state(state), gt, w2c, Ks, PAR_STEPS,
                               tcfg, enable_pruning=True, mcfg=mcfg)
    same = losses_r == losses1 and same_bits(st_r, st1)
    del st_r
    check(same, "[parallel] two meshless runs from one state differ")
    unmoved = rel_steps(losses_r, losses1)
    spread = np.max([rel_steps(run_optim(
        nudged_state(state, toward), gt, w2c, Ks, PAR_STEPS, tcfg,
        enable_pruning=True, mcfg=mcfg)[1], losses1)
        for toward in (np.inf, -np.inf)[:PAR_REPEATS]], axis=0)
    loss_tol = max(PAR_LOSS_RTOL, 2 * float(spread.max()))
    # the limit as it stood when the yardstick was the unmoved repeats
    # (what float atomics made them part by), for the record
    old_tol = max(PAR_LOSS_RTOL, 2 * float(unmoved.max()))
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
          f"{PAR_LOSS_RTOL} or twice the meshless run's spread under a "
          f"one-ulp move of its start, {spread.max():.3g}), last "
          f"{losses_m[-1]:.6f}; n_alive {st_m.n_alive}; parameters "
          f"{'equal' if same_bits(st_m, st1) else 'not equal'} bit for bit "
          f"to the meshless run's; launches {launches}", flush=True)
    print(f"[parallel] yardsticks: a second meshless run from the same "
          f"state gives the same bits (largest relative distance "
          f"{unmoved.max():.3g}: the limit with that yardstick "
          f"{old_tol:.3g}); the one-ulp runs' spread {spread.max():.3g} "
          f"(limit {loss_tol:.3g}); world 1's distance {rel.max():.3g}",
          flush=True)
    print(f"[parallel] per step, relative: the one-ulp runs against the "
          f"meshless run {np.round(spread, 7).tolist()}; the mesh's against "
          f"it {np.round(rel, 7).tolist()}", flush=True)
    check(rel[0] <= PAR_FIRST_RTOL, f"sharded first loss off by {rel[0]}")
    check(rel.max() <= loss_tol, f"sharded losses off by {rel.max()}")
    check(all(bool(torch.isfinite(v).all()) for v in st_m.params.values()),
          "sharded training left non-finite parameters")
    for name in ("composite_fwd_packed", "composite_bwd_packed",
                 "gather_rows_bwd"):
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
          f"{rel2[0]:.3g}, limit {PAR_FIRST_RTOL}; limit {loss_tol:.3g}, "
          f"the one-ulp yardstick; {old_tol:.3g} with the unmoved repeats "
          f"as the yardstick); per step {np.round(rel2, 7).tolist()}; "
          f"launches per rank {o['launches']}", flush=True)
    check(rel2[0] <= PAR_FIRST_RTOL, f"world-2 first loss off by {rel2[0]}")
    check(rel2.max() <= loss_tol, f"world-2 losses off by {rel2.max()}")
    for name in ("composite_fwd_packed", "composite_bwd_packed",
                 "gather_rows_bwd"):
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


def packed_bwd_plain_by_camera(x, done, g_rgb, g_alpha):
    """The packed backward's plain version (`composite_packed_bwd_plain`,
    autograd through the plain forward) on input ``x``, one camera at a
    time, the cameras' tables summed: the function splits by camera (a
    camera's slots, pixels and gradients are its own), and on six 512 x
    384 cameras at once autograd would hold several times the memory."""
    import torch
    from starst3r_tpu_torch.splat import composite as comp
    c, t = x["counts"].shape
    done = done.reshape(c, t)
    out = torch.zeros_like(x["packed"])
    for ci in range(c):
        out += comp.composite_packed_bwd_plain(
            x["packed"], x["gidx"][ci:ci + 1], x["counts"][ci:ci + 1],
            done[ci], g_rgb[ci:ci + 1], g_alpha[ci:ci + 1], *geometry(x))
    return out


def save_ga_calls(calls, path):
    """Each recorded GA call's inputs (condensed data, MST, GAConfig, warm
    start) and the card's result, as numpy, pickled to ``path``."""
    import dataclasses
    import pickle
    with open(path, "wb") as f:
        pickle.dump([dict(
            data=args[0]._asdict(), mst=args[1],
            cfg=dataclasses.asdict(args[2]),
            prev=None if kw.get("prev_params") is None
            else [p.detach().cpu().numpy() for p in kw["prev_params"]],
            cam2w=out[0].cam2w.cpu().numpy(), K=out[0].K.cpu().numpy(),
            losses=(out[0].loss_coarse, out[0].loss_fine))
            for args, kw, out in calls], f)
    print(f"[res512] recorded {len(calls)} GA calls to {path}", flush=True)


def res512_phase(stt, model, dev, work_dir, record=None):
    """`[res512]`: the main path on 4:3 photos at the checkpoint's 512 px,
    on ``model``: six 640 x 480 PNGs through `load_images(size=512)` (the
    native route), then `drive_main_path` (`Scene.add_images` 4 + 2 at the
    default GA, `init_3dgs` with more dense points than `cap_max`, so the
    pool is the points, full, and the renders), `run_3dgs_optim` with MCMC
    for RES_STEPS steps, the renders again; then K1, K2 (packed) and G1
    held to their plain versions at these shapes and timed beside their
    bounds. With ``record`` (a path) the two GA calls' inputs and the
    card's results are written there for tools/res512_ga_against_jax.py.
    Returns the host seconds per stage and {kernel: its times, bound and
    error}."""
    import glob
    import torch
    import starst3r_tpu_torch.reconstruct as reconstruct_mod
    from starst3r_tpu_torch.alignment import ga
    from starst3r_tpu_torch.splat.mcmc import grow_target
    from starst3r_tpu_torch.splat.train import mcmc_config_from
    from torch_slice_inputs import recorded_calls

    t0 = time.perf_counter()
    h, w = RES_HW
    imgdir = os.path.join(work_dir, "res512")
    write_view_pngs(make_views(N_VIEWS, RES_PHOTO_HW), imgdir)
    paths = sorted(glob.glob(os.path.join(imgdir, "*.png")))
    load_secs, load_peak = {}, {}
    imgs = timed_stage(load_secs, load_peak, dev, "load_images",
                       lambda: stt.load_images(paths, size=RES_SIZE,
                                               impl="native"))
    check([im.shape for im in imgs] == [(3, h, w)] * N_VIEWS,
          f"[res512] load_images gave {[im.shape for im in imgs]}")

    set_launches(0)
    with recorded_calls(reconstruct_mod) as ga_calls, \
            counted_forwards() as forwards:
        scene, orig, novel, secs, peak = drive_main_path(
            stt, model, imgs, dev, N_NOVEL,
            os.path.join(work_dir, "res512_pairs"))
    path_launches = read_launches()
    check_attention_launches(path_launches, forwards, model.cfg, "res512")
    check(len(forwards) > 0, "[res512] add_images ran no forward")
    secs, peak = dict(load_secs, **secs), dict(load_peak, **peak)
    if record:
        save_ga_calls(ga_calls, record)
    c2w, K = np.asarray(scene.c2w), np.asarray(scene.intrinsics)
    pp = K[:, :2, 2]
    near = np.linalg.norm(pp - [w / 2, h / 2], axis=-1)
    swapped = np.linalg.norm(pp - [h / 2, w / 2], axis=-1)
    n_pts = int(scene.dense_pts_flat.shape[0])
    ga_cfg = ga_calls[0].args[2]
    want_loss = len(ga_calls) * ga_loss_calls(ga_cfg)
    g1_launches = path_launches["gather_rows_bwd"]
    print(f"[res512] {N_VIEWS} photos of {RES_PHOTO_HW[1]} x "
          f"{RES_PHOTO_HW[0]} -> load_images(size={RES_SIZE}) "
          f"{imgs[0].shape}; GA losses {scene.reconstruction.losses}; "
          f"principal points {np.round(pp, 2).tolist()} (distance to "
          f"({w / 2}, {h / 2}) {np.round(near, 2).tolist()}, to the swap "
          f"({h / 2}, {w / 2}) {np.round(swapped, 2).tolist()}); focals "
          f"{np.round(K[:, 0, 0], 2).tolist()}; dense points {n_pts} (at "
          f"most {N_VIEWS * h * w}); fused loss calls "
          f"{path_launches['ga_loss']} (want {want_loss}), row-gather "
          f"backward launches {g1_launches} (want 0)", flush=True)
    check(len(ga_calls) == 2, f"[res512] {len(ga_calls)} GA calls")
    check(bool((near < swapped).all()), "[res512] a principal point is "
          "nearer the swapped image centre")
    check(0 < n_pts <= N_VIEWS * h * w
          and bool(np.isfinite(scene.dense_pts_flat).all()),
          f"[res512] dense points: {n_pts}, finite "
          f"{np.isfinite(scene.dense_pts_flat).all()}")
    check(g1_launches == 0 and path_launches["ga_loss"] == want_loss == 16,
          f"[res512] the GA launched gather_rows_bwd {g1_launches} times "
          f"and called the fused loss {path_launches['ga_loss']} times, "
          f"want 0 and {want_loss} (16)")

    cfg = scene.config.splat
    pool = int(scene.gs_state.params["means"].shape[0])
    n0 = int(scene.gs_state.n_alive)
    reserved = min(cfg.cap_max, int(cfg.pool_headroom * n_pts))
    print(f"[res512] init_3dgs: N {n_pts} dense points, pool_size {pool}, "
          f"n_alive {n0}, cap_max {cfg.cap_max} (reserved min(cap_max, "
          f"{cfg.pool_headroom} N) = {reserved})", flush=True)
    check(n_pts > cfg.cap_max and reserved < n_pts and pool == n0 == n_pts,
          "[res512] init_3dgs did not take the full-pool branch")

    check_outputs(scene, orig, novel, N_VIEWS, RES_HW, N_NOVEL)
    check(path_launches["composite_fwd_packed"] > 0,
          "[res512] the renders did not launch the packed forward kernel")
    tiles = -(-w // cfg.tile_size) * -(-h // cfg.tile_size)
    print(f"[res512] renders: {tiles} tiles a camera; original views "
          f"tile_overflow {orig[2]['tile_overflow'].tolist()} "
          f"n_tiles_clipped {orig[2]['n_tiles_clipped'].tolist()}, mean "
          f"alpha {float(orig[1].mean()):.4f}; novel views tile_overflow "
          f"{novel[2]['tile_overflow'].tolist()} n_tiles_clipped "
          f"{novel[2]['n_tiles_clipped'].tolist()}; launches over the "
          f"path {path_launches}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    (losses, train_s, train_launches, nonfinite, after_launches, orig_t,
     novel_t) = drive_training(stt, scene, N_NOVEL, steps=RES_STEPS)
    secs["train"] = train_s
    peak["train"] = torch.cuda.max_memory_allocated(dev)
    n1 = int(scene.gs_state.n_alive)
    first = float(np.mean(losses[:RES_WINDOW]))
    last = float(np.mean(losses[-RES_WINDOW:]))
    params_bad = {k: int((~torch.isfinite(v)).sum())
                  for k, v in scene.gs_state.params.items()}
    want_n = n0
    mcfg = mcmc_config_from(scene.config.splat)
    for _ in range(REFINE_START, RES_STEPS + 1, REFINE_EVERY):
        want_n = grow_target(want_n, pool, mcfg)
    print(f"[res512] train {RES_STEPS} steps in {train_s:.3f} s: "
          f"{1e3 * train_s / RES_STEPS:.3f} ms/step (host clock); loss "
          f"first {losses[0]:.6f} last {losses[-1]:.6f}, mean of the first "
          f"{RES_WINDOW} {first:.6f}, of the last {RES_WINDOW} {last:.6f}; "
          f"n_alive {n0} -> {n1} (pool {pool}, grow_target {want_n}); "
          f"non-finite out of the backward kernels {nonfinite}, in the "
          f"trained parameters {params_bad}; launches {train_launches}, "
          f"in the renders after {after_launches}", flush=True)
    check(len(losses) == RES_STEPS and all(np.isfinite(losses)),
          "[res512] a training loss is not finite")
    check(last < first, f"[res512] the loss did not fall ({first} -> "
          f"{last})")
    check(n1 <= pool and n1 == want_n, f"[res512] n_alive {n1}, pool "
          f"{pool}, grow_target {want_n}")
    check(sum(params_bad.values()) == 0, f"[res512] non-finite trained "
          f"parameters {params_bad}")
    check(nonfinite["composite_bwd_packed"] == 0, f"[res512] K2 gave "
          f"{nonfinite['composite_bwd_packed']} non-finite values")
    for name in ("composite_fwd_packed", "composite_bwd_packed"):
        check(train_launches[name] > 0, f"[res512] training did not "
              f"launch {name}")
    check(train_launches["gather_rows_bwd"]
          == train_launches["composite_bwd_packed"], "[res512] training "
          f"launched the row sum {train_launches['gather_rows_bwd']} times, "
          f"K2 {train_launches['composite_bwd_packed']}")
    check_outputs(scene, orig_t, novel_t, N_VIEWS, RES_HW, N_NOVEL)
    print(f"[res512] after training, mean alpha: original views "
          f"{float(orig_t[1].mean()):.4f}, novel views "
          f"{float(novel_t[1].mean()):.4f}", flush=True)
    stages, wall_ms, busy_ms, host, _ = profile_train_steps(scene)
    secs["repeat"] = repeat_phase("512 x 384", scene, REPEAT_RES_STEPS)
    print("[res512] train-stages stream ms per step (CUDA events): "
          + " ".join(f"{k}={v:.3f}" for k, v in stages.items())
          + f" total={sum(stages.values()):.3f}; 5 steps under "
          f"torch.profiler: wall {wall_ms / 5:.3f} ms a step, device busy "
          + (f"{busy_ms / 5:.3f} ms a step" if busy_ms else "not measured")
          + "; host ms per step by stage: "
          + " ".join(f"{k}={v:.3f}" for k, v in host.items()), flush=True)

    # the kernels at these shapes: K1 on the renders' inputs, K2 on the
    # trained scene's, G1 at the six sites of the first GA call
    render_in = render_case_inputs(scene, dev)
    packed_out = run_fwd(render_in, "packed")
    entries_out = run_fwd(render_in, "entries")
    torch.cuda.synchronize()
    for name, a, b in zip(("rgb", "alpha", "tfin", "done"), packed_out,
                          entries_out):
        check(torch.equal(a, b), f"[res512] K1's packed {name} differs "
              "from the entries route's")
    del packed_out, entries_out
    k1 = composite_case("res512 render", render_in, "packed", timed=True)
    del render_in

    real = trained_inputs(scene, dev)
    x, g_rgb, g_alpha = real["x"], real["g_rgb"], real["g_alpha"]
    del real
    geo = geometry(x)
    fwd = run_fwd(x, "packed")
    done = fwd[3]
    got = run_bwd(x, "packed", fwd, g_rgb, g_alpha)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "[res512] K2's gradient is not "
          "finite")
    check_done("res512 trained", x["entries"], x["counts"], done,
               *geo[2:])
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    want = packed_bwd_plain_by_camera(x, done, g_rgb, g_alpha)
    plain_peak = torch.cuda.max_memory_allocated(dev) - base
    k2_err = max(scaled_errors(got, want))
    k2_abs = float((got - want).abs().max())
    del want
    grad = run_bwd(x, "entries", fwd, g_rgb, g_alpha)
    chain = torch.zeros_like(x["packed"]).index_add_(
        0, x["gidx"].reshape(-1), (grad * x["valid"][..., None]).reshape(-1, 9))
    del grad
    chain_err = max(scaled_errors(got, chain))
    del chain, got
    print(f"[res512] kernel composite_bwd (packed route) on the trained "
          f"scene: max scaled |kernel - plain| = {k2_err:.3e} (the plain "
          f"version one camera at a time, {plain_peak / 2**20:.1f} MiB "
          f"allocated at its peak; gate {BWD_SCALED_TOL}), max abs "
          f"{k2_abs:.3e}; against the entries route's index_add_ "
          f"{chain_err:.3e} (gate {FUSED_SCALED_TOL})", flush=True)
    check(k2_err <= BWD_SCALED_TOL, f"[res512] K2 (packed) differs from its "
          f"plain version by {k2_err:.3e} (scaled) > {BWD_SCALED_TOL}")
    check(chain_err <= FUSED_SCALED_TOL, f"[res512] K2 (packed) differs from "
          f"the entries route's index_add_ by {chain_err:.3e} (scaled) > "
          f"{FUSED_SCALED_TOL}")
    k2 = bwd_work(x, done)
    k2["ms"] = device_ms(lambda: run_bwd(x, "packed", fwd, g_rgb, g_alpha),
                         reps=20)
    k2["plain_ms"] = cuda_ms(lambda: packed_bwd_plain_by_camera(
        x, done, g_rgb, g_alpha), reps=3, warmup=1)
    k2["max_abs_err"] = k2_err
    parts = packed_bwd_parts(x, fwd, g_rgb, g_alpha, "512 x 384")
    k2["parts"] = {key: v for key, v in parts.items() if key != "row_sum"}
    del fwd, x, g_rgb, g_alpha

    g1 = ga_gather_phase({"res512": ga.make_state(*ga_calls[0].args[:3],
                                                  device=dev)}, dev)[0]
    g1 = g1["res512"]
    kernels = {}
    for name, case in (("composite_fwd", k1), ("composite_bwd", k2),
                       ("gather_rows_bwd", g1),
                       ("gather_rows_bwd_packed", parts["row_sum"])):
        b_ms, b_by = bound(case["bytes"], case["ops"])
        kernels[name] = {"ms": case["ms"], "bound_ms": b_ms,
                         "bound_by": b_by, "bytes": case["bytes"],
                         "ops": case["ops"],
                         "max_abs_err": case["max_abs_err"],
                         "plain_ms": case.get("plain_ms"),
                         "library_ms": case.get("library_ms"),
                         **({"parts": case["parts"]} if "parts" in case
                            else {})}
        print(f"[res512] kernel {name}: {case['ms']:.4f} ms (device_ms), "
              f"bound {b_ms:.4f} ms ({b_by}: {case['bytes']} B, "
              f"{case['ops']} ops), {case['ms'] / b_ms:.1f}x; error "
              f"{case['max_abs_err']:.3e}; plain "
              f"{case.get('plain_ms')} ms; work {case.get('pairs')}",
              flush=True)
    secs["phase"] = time.perf_counter() - t0
    print("[res512] peak device memory allocated per stage, the model and "
          "the earlier phases' tensors included (MiB): " + " ".join(
              f"{k}={v / 2**20:.1f}" for k, v in peak.items()), flush=True)
    return secs, kernels


VGGT_VIEWS = 32
VGGT_PHOTO_HW = (480, 640)


def vggt_phase(dev=None):
    """`[vggt]` (module docstring, item 22); returns its seconds."""
    import torch
    from PIL import Image
    import starst3r_tpu_torch as stt
    from starst3r_tpu_torch import cli
    from starst3r_tpu_torch.ops import attention
    dev = dev or torch.device("cuda", 0)
    # float32 as the configuration states it (the heads' convolutions
    # too), also when the phase runs on its own
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = {}
    t = time.perf_counter()
    model = stt.VGGTModel.init_random(stt.VGGTConfig.vggt_1b(), seed=0,
                                      device=dev)
    torch.cuda.synchronize()
    secs["init"] = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.net.parameters())
    print(f"[vggt] VGGTConfig.vggt_1b(): {n_params} parameters, init "
          f"{secs['init']:.2f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vggt_") as d:
        paths = []
        for k, v in enumerate(make_views(VGGT_VIEWS, VGGT_PHOTO_HW)):
            arr = np.clip((v.transpose(1, 2, 0) * 0.5 + 0.5) * 255 + 0.5,
                          0, 255).astype(np.uint8)
            paths.append(os.path.join(d, f"v{k:02d}.png"))
            Image.fromarray(arr).save(paths[-1])
        t = time.perf_counter()
        imgs = stt.load_images(paths, size=518, mode="crop")
        secs["load"] = time.perf_counter() - t
        check(all(im.shape == (3, 392, 518) for im in imgs),
              f"[vggt] crop mode gave {imgs[0].shape}")
        scene = stt.Scene(device=dev)
        attention.fused_sdpa.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        scene.add_images(model, imgs)
        torch.cuda.synchronize()
        secs["add_images"] = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev)
        launches = attention.fused_sdpa.launches
        check(launches == 24 + 2 * 24,
              f"[vggt] the fused route launched {launches} times")
        c2w, K = scene.c2w, scene.intrinsics
        rot = c2w[:, :3, :3]
        check(np.isfinite(c2w).all() and np.allclose(
            rot @ rot.transpose(0, 2, 1), np.eye(3), atol=1e-4),
            "[vggt] poses not finite and orthonormal")
        check(np.isfinite(K).all() and (K[:, 0, 0] > 0).all()
              and (K[:, 1, 1] > 0).all(), "[vggt] focals")
        check(np.allclose(K[:, :2, 2], [259.0, 196.0]),
              "[vggt] principal points off the centre")
        pts = scene.dense_pts_flat
        check(pts.shape[0] > 0 and np.isfinite(pts).all(),
              "[vggt] dense points")
        t = time.perf_counter()
        scene.init_3dgs()
        losses = scene.run_3dgs_optim(2)
        torch.cuda.synchronize()
        secs["init_3dgs_train2"] = time.perf_counter() - t
        check(np.isfinite(losses).all(), "[vggt] 3DGS losses")
        print(f"[vggt] add_images of {VGGT_VIEWS} views: "
              f"{secs['add_images']:.3f} s, peak device memory {peak} B, "
              f"{pts.shape[0]} dense points above the threshold of "
              f"{VGGT_VIEWS * 392 * 518}; focals "
              f"{K[:, 0, 0].min():.1f}-{K[:, 0, 0].max():.1f}; 3DGS losses "
              f"{[round(float(x), 4) for x in losses]}", flush=True)
        t = time.perf_counter()
        rc = cli.main(["--device", "cuda", "reconstruct", "--imgdir", d,
                       "--out", os.path.join(d, "out"), "--preset",
                       "vggt_1b", "--gs-iters", "2"])
        secs["cli"] = time.perf_counter() - t
        check(rc == 0, f"[vggt] the CLI returned {rc}")
    x = torch.stack([torch.as_tensor(im) for im in imgs]).to(dev)

    def forward():
        with torch.inference_mode():
            return model.net(x)

    # CUDA events (`cuda_ms`): a forward queues thousands of launches,
    # more than the launch queue holds behind `device_ms`'s spin
    fwd_ms = cuda_ms(forward, 3, warmup=1)
    t_tok = VGGT_VIEWS * (5 + 28 * 37)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(1, t_tok, 16, 64, device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    attn_ms = device_ms(lambda: attention.fused_sdpa(q, k, v), 10)
    tflops = 4.0 * t_tok * t_tok * 1024 / (attn_ms * 1e-3) / 1e12
    print(f"[vggt] the forward at {VGGT_VIEWS} views: {fwd_ms:.3f} ms "
          f"(CUDA events); the fused attention alone at {t_tok} tokens: "
          f"{attn_ms:.3f} ms ({tflops:.1f} TFLOP/s of 989), x 24 "
          f"{24 * attn_ms / fwd_ms:.1%} of the forward", flush=True)
    print("[stages] vggt: " + " ".join(f"{k}={v:.3f}s"
                                       for k, v in secs.items()), flush=True)
    del model, scene, x, q, k, v
    torch.cuda.empty_cache()
    return secs


def attention_phase(dev=None, model=None):
    """`[rope-attn]` (module docstring, item 23). Returns the rotation
    kernel's and the attention kernel's rows of the `kernels` line."""
    import torch
    import torch.nn.functional as F
    import starst3r_tpu_torch as stt
    from starst3r_tpu_torch.models import vit
    from starst3r_tpu_torch.ops import attention
    from starst3r_tpu_torch.ops.rope import rope_2d_freqs, rope_rotate
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.append(tests)
    from torch_attention_cases import attention_f64, attention_inputs
    dev = dev or torch.device("cuda", 0)

    def library(q, k, v, rope_q, rope_k):
        q, k = rope_rotate(q, *rope_q), rope_rotate(k, *rope_k)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2),
            v.transpose(1, 2)).transpose(1, 2)

    def rotated_once(q, k, v, rope_q, rope_k):
        q, k = attention.rope_rotate_qk(q, k, rope_q, rope_k)
        return attention._rope_attention_cuda(q, k, v, None, None)

    cases = {}
    for n, (name, b, grid, heads, kind) in enumerate(ATTN_CASES):
        args = attention_inputs(dev, b, grid, heads, 64, kind,
                                torch.bfloat16, seed=n)
        q, k, v, rope_q, rope_k = args
        t = q.shape[1]
        before = attention.rope_attention.launches
        got = attention.rope_attention(*args)
        check(attention.rope_attention.launches == before + 1,
              f"[rope-attn] {name}: the call did not count")
        plain = attention._rope_attention_plain(*args)
        want = attention_f64(*args)
        scale = float(want.abs().max())
        err = float((got.double() - want).abs().max())
        err_plain = float((plain.double() - want).abs().max())
        check(got.shape == q.shape and got.dtype == torch.bfloat16
              and got.is_contiguous(), f"[rope-attn] {name}: output layout")
        check(bool(torch.isfinite(got).all()),
              f"[rope-attn] {name}: non-finite output")
        check(err <= 2.0 * err_plain + ATTN_SLACK * scale,
              f"[rope-attn] {name}: {err} from float64, the plain version "
              f"{err_plain} (scale {scale})")
        flops = 4.0 * b * heads * t * t * 64
        n_bytes = (4 * b * t * heads * 64 * 2
                   + (1 if kind == "self" else 2) * 2 * t * 64 * 4)
        bound_ms = max(flops / PEAK_BF16, n_bytes / PEAK_BYTES) * 1e3
        check(t < attention.ROTATE_ONCE_KEYS, f"[rope-attn] {name}: "
              f"{t} keys take the rotate-once route")
        ms = device_ms(lambda: attention.rope_attention(*args), 20)
        once_ms = device_ms(lambda: rotated_once(*args), 20)
        plain_ms = device_ms(lambda: attention._rope_attention_plain(*args),
                             5)
        library_ms = device_ms(lambda: library(*args), 20)
        cases[name] = dict(ms=ms, once_ms=once_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           err=err, err_plain=err_plain, scale=scale,
                           flops=flops, bytes=n_bytes)
        print(f"[rope-attn] {name} (B {b}, T {t}, H {heads}, D 64, {kind}): "
              f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), bound "
              f"{bound_ms:.4f} ms ({bound_ms / ms:.1%}), rotated once "
              f"{once_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {library_ms:.4f} ms; max gap to "
              f"float64 {err:.3e}, the plain version's {err_plain:.3e} "
              f"(largest value {scale:.3f})", flush=True)
        del args, q, k, v, got, plain, want

    if model is None:
        model = stt.Mast3rModel.init_random(stt.ModelConfig.large(), seed=0,
                                            device=dev)
    cfg, net = model.cfg, model.net
    for hw in ((384, 512), (160, 224)):
        gen = torch.Generator(device=dev).manual_seed(hw[1])
        imgs = torch.rand(16, *hw, 3, device=dev, generator=gen) * 2 - 1
        pos = vit.patch_positions(hw[0] // 16, hw[1] // 16, dev)[None]
        rope_enc = rope_2d_freqs(pos, cfg.enc_dim // cfg.enc_heads)
        rope_dec = rope_2d_freqs(pos, cfg.dec_dim // cfg.dec_heads)
        ctx = lambda: torch.autocast("cuda", dtype=torch.bfloat16)
        with torch.inference_mode():
            with ctx():
                feats = net.encode(imgs, rope_enc)
            f1, f2 = feats[:8], feats[8:]

            def encode():
                with ctx():
                    net.encode(imgs, rope_enc)

            def decode():
                with ctx():
                    net.decode(f1, f2, rope_dec)

            before = attention.rope_attention.launches
            model.infer_pair_batch(imgs[:8], imgs[8:])
            launched = attention.rope_attention.launches - before
            fwd = dict(launches=launched, encoder_ms=cuda_ms(encode, 3),
                       decoder_ms=cuda_ms(decode, 3))
        want = cfg.enc_depth + 4 * cfg.dec_depth
        check(launched == want, f"[rope-attn] a forward launched the kernel "
              f"{launched} times, want {want}")
        print(f"[rope-attn] large network at {hw[1]} x {hw[0]}, 8 pairs a "
              f"forward: encoder {fwd['encoder_ms']:.3f} ms, decoder "
              f"{fwd['decoder_ms']:.3f} ms (CUDA events), {launched} kernel "
              f"launches", flush=True)
        cases[f"forward {hw[1]}"] = fwd
        del imgs, feats, f1, f2
    torch.cuda.empty_cache()
    fusion, rotate_row = fusion_attention(dev, rotated_once)
    cases["fusion"] = fusion
    main_case = cases[ATTN_CASES[0][0]]
    return rotate_row, {"name": "rope_attention", "route": "cuda",
            "source": "starst3r_tpu_torch/csrc/rope_attention.cu",
            "replaces": "none (the JAX package leaves attention to XLA: "
            "starst3r_tpu/ops/attention.py, ops/rope.py)",
            "max_abs_err": max(c["err"] for c in cases.values()
                               if "err" in c),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "library_ms": main_case["library_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": "operations",
            "cases": cases}


def fusion_attention(dev, rotated_once):
    """`[rope-attn]`'s Fast3R part (module docstring, item 23). Returns
    (the fusion call's case, the rotation kernel's row of the `kernels`
    line)."""
    import numpy as np
    import torch
    import starst3r_tpu_torch as stt
    from starst3r_tpu_torch.models import vit
    from starst3r_tpu_torch.ops import attention
    from starst3r_tpu_torch.ops.rope import rope_2d_freqs, rope_rotate
    views, heads = FUSION_CASE
    t = views * 768
    gen = torch.Generator(device=dev).manual_seed(views)
    qkv = torch.randn(1, t, 3, heads, 64, device=dev, generator=gen)
    qkv[:, :, 0] *= FUSION_Q_GAIN
    q, k, v = qkv.to(torch.bfloat16).unbind(2)
    del qkv
    rope = rope_2d_freqs(vit.patch_positions(24, 32, dev).repeat(views, 1)
                         [None], 64)
    check(t >= attention.ROTATE_ONCE_KEYS, f"[rope-attn] the fusion call's "
          f"{t} keys do not take the rotate-once route")
    qr, kr = attention.rope_rotate_qk(q, k, rope, rope)
    check(torch.equal(qr, rope_rotate(q, *rope))
          and torch.equal(kr, rope_rotate(k, *rope)), "[rope-attn] fusion: "
          "the rotation kernel is not the plain rotation bit for bit")
    # q and k read and written in bfloat16, the cos and sin rows once (q's
    # and k's tables are the same rows in a fusion call): 427.8 MB, as
    # benchmark/benchlib/fast3r_work.py::rotate_bytes counts a call
    rot_bytes = 4 * t * heads * 64 * 2 + 2 * t * 64 * 4
    rot_bound_ms = rot_bytes / PEAK_BYTES * 1e3
    rot_ms = device_ms(lambda: attention.rope_rotate_qk(q, k, rope, rope),
                       20)
    rot_plain_ms = device_ms(lambda: (rope_rotate(q, *rope),
                                      rope_rotate(k, *rope)), 5)
    counts = (attention.rope_rotate_qk.launches,
              attention.rope_attention.launches)
    got = attention.rope_attention(q, k, v, rope, rope)
    check((attention.rope_rotate_qk.launches - counts[0],
           attention.rope_attention.launches - counts[1]) == (1, 1),
          "[rope-attn] fusion: the call is not one rotation and one "
          "attention launch")
    check(torch.equal(got, attention._rope_attention_cuda(q, k, v, rope,
                                                          rope)),
          "[rope-attn] fusion: rotated once differs from the tables route")
    # the yardstick's control: the kernel on q and k left unrotated
    skipped = attention._rope_attention_cuda(q, k, v, None, None)
    err = err_skip = scale = 0.0
    for h in range(heads):
        kh, vh = kr[0, :, h].float(), v[0, :, h].float()
        for r0 in range(0, t, 4096):
            want = torch.softmax(qr[0, r0:r0 + 4096, h].float() @ kh.T
                                 * 0.125, dim=-1) @ vh
            err = max(err, float((got[0, r0:r0 + 4096, h].float() - want)
                                 .abs().max()))
            err_skip = max(err_skip, float(
                (skipped[0, r0:r0 + 4096, h].float() - want).abs().max()))
            scale = max(scale, float(want.abs().max()))
    del skipped, want
    check(err <= FUSION_TOL * scale, f"[rope-attn] fusion: {err} from "
          f"float32 attention (largest value {scale})")
    check(err_skip > FUSION_TOL * scale, f"[rope-attn] fusion: the kernel "
          f"on unrotated q and k is within {FUSION_TOL} of the largest "
          f"value ({err_skip} of {scale}): the comparison cannot tell")
    once_ms = device_ms(lambda: attention.rope_attention(q, k, v, rope,
                                                         rope), 3)
    tables_ms = device_ms(lambda: attention._rope_attention_cuda(
        q, k, v, rope, rope), 3)
    kernel_ms = device_ms(lambda: attention._rope_attention_cuda(
        qr, kr, v, None, None), 3)
    flops = 4.0 * heads * t * t * 64
    fusion = dict(once_ms=once_ms, tables_ms=tables_ms, ms=kernel_ms,
                  err=err, err_unrotated=err_skip, scale=scale, flops=flops,
                  bound_ms=flops / PEAK_BF16 * 1e3)
    print(f"[rope-attn] fusion (B 1, T {t}, H {heads}, D 64): rotated once "
          f"{once_ms:.4f} ms (the kernel alone {kernel_ms:.4f} ms, "
          f"{flops / kernel_ms / 1e9:.1f} TFLOP/s, "
          f"{fusion['bound_ms'] / kernel_ms:.1%} of its bound), the kernel "
          f"with its tables {tables_ms:.4f} ms; max gap to float32 "
          f"{err:.3e}, unrotated {err_skip:.3e} (largest value "
          f"{scale:.4f}, tolerance {FUSION_TOL * scale:.3e})", flush=True)
    print(f"[rope-attn] rotation (B 1, T {t}, H {heads}, D 64): "
          f"{rot_ms:.4f} ms, bound {rot_bound_ms:.4f} ms "
          f"({rot_bound_ms / rot_ms:.1%}; {rot_bytes} B), plain "
          f"{rot_plain_ms:.4f} ms; bit for bit the plain rotation",
          flush=True)
    del q, k, v, qr, kr, got, rope
    torch.cuda.empty_cache()

    cfg = stt.Fast3RConfig.fast3r_vitl_512()
    model = stt.Fast3RModel.init_random(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1, 1, (3, 384, 512)).astype(np.float32)
            for _ in range(FAST3R_VIEWS)]
    check(FAST3R_VIEWS * 768 >= attention.ROTATE_ONCE_KEYS,
          "[rope-attn] the Fast3R forward's fusion calls are too short to "
          "rotate once")
    model.infer(imgs)
    torch.cuda.synchronize()
    set_launches(0)
    model.infer(imgs)
    torch.cuda.synchronize()
    launched = read_launches()
    want = (cfg.dec_depth, cfg.enc_depth * -(-FAST3R_VIEWS // cfg.enc_chunk)
            + cfg.dec_depth)
    fwd_ms = cuda_ms(lambda: model.infer(imgs), 2)
    print(f"[rope-attn] Fast3R ViT-L/512 at {FAST3R_VIEWS} views: "
          f"{launched['rope_rotate']} rotations and "
          f"{launched['rope_attention']} attention launches a forward (want "
          f"{want[0]} and {want[1]}), {fwd_ms:.2f} ms a forward (CUDA "
          f"events)", flush=True)
    check((launched["rope_rotate"], launched["rope_attention"]) == want,
          f"[rope-attn] a Fast3R forward launched {launched['rope_rotate']} "
          f"rotations and {launched['rope_attention']} attentions, want "
          f"{want}")
    fusion.update(fast3r_forward_ms=fwd_ms, fast3r_views=FAST3R_VIEWS)
    del model
    torch.cuda.empty_cache()
    return fusion, {
        "name": "rope_rotate", "route": "cuda", "function": "rope_rotate",
        "source": "starst3r_tpu_torch/csrc/rope_attention.cu",
        "replaces": "none (the JAX package leaves the rotation to XLA: "
        "starst3r_tpu/ops/rope.py apply_rope_2d)",
        "max_abs_err": 0.0, "ms": rot_ms, "plain_ms": rot_plain_ms,
        "library_ms": None, "bound_ms": rot_bound_ms, "bound_by": "bytes",
        "bytes": rot_bytes, "launches_fast3r": launched["rope_rotate"]}


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
    parser.add_argument(
        "--res512-record", default=None, metavar="PATH",
        help="write `[res512]`'s two GA calls (inputs and the card's "
        "results) to PATH, for tools/res512_ga_against_jax.py")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's entry points run on the card",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    # the tests' GA call recorder (tests/torch_slice_inputs.py)
    sys.path.append(os.path.join(root, "tests"))
    import starst3r_tpu_torch as stt
    from starst3r_tpu_torch import kernels
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
            SIDE_BY_SIDE + ("gather_rows_bwd",),
            csrc=args.parent_csrc).items()})
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
    t = time.perf_counter()
    rotate_row, attention_row = attention_phase(dev, model)
    print(f"[stages] rope-attn: {time.perf_counter() - t:.3f}s", flush=True)

    # the pair cache and the checkpoints; removed at the end (and, after a
    # failed check, when the interpreter exits)
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    cache_dir = os.path.join(work.name, "pairs")

    # slice 1: reconstruct and render; the GA calls' arguments are kept
    # for `[ga-graph]`
    import starst3r_tpu_torch.reconstruct as reconstruct_mod
    from torch_slice_inputs import recorded_calls
    set_launches(0)
    set_ga_counts(0)
    with recorded_calls(reconstruct_mod) as ga_calls, \
            counted_forwards() as forwards:
        scene, orig, novel, secs, _ = drive_main_path(stt, model, views, dev,
                                                      N_NOVEL, cache_dir)
    ga_counts = read_ga_counts()
    render_launches = read_launches()
    check_attention_launches(render_launches, forwards, model.cfg,
                             "launches")
    check(len(forwards) > 0, "add_images ran no forward")
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
    ga_secs = [rec["ga"] for rec in scene.logger.records
               if rec["event"] == "reconstruct"]
    ga_cfg = ga_calls[0][0][2]
    want = {"captures": 2 * len(ga_calls),
            "replays": len(ga_calls) * (ga_cfg.niter1 + ga_cfg.niter2),
            "host_reads": len(ga_calls) * ga_reads(ga_cfg)}
    print(f"[ga] seconds per add_images call {[round(x, 3) for x in ga_secs]}"
          f"; the graph route's counts over both {ga_counts} (want {want})",
          flush=True)
    check(len(ga_calls) == 2, f"{len(ga_calls)} GA calls on the main path")
    check(ga_counts == want, f"main-path GA counts {ga_counts}, want {want}")
    want = len(ga_calls) * ga_loss_calls(ga_cfg)
    print(f"[ga] fused loss calls over both: {render_launches['ga_loss']} "
          f"(want {want}: the warm-up steps and captures; the replays "
          f"launch it unseen); row-gather backward launches "
          f"{render_launches['gather_rows_bwd']} (want 0)", flush=True)
    check(render_launches["ga_loss"] == want
          and render_launches["gather_rows_bwd"] == 0,
          f"the GA called the fused loss {render_launches['ga_loss']} times "
          f"and launched gather_rows_bwd "
          f"{render_launches['gather_rows_bwd']} times, want {want} and 0")
    print(f"[ga] GA step calls (ga_reparam, the fused loss, ga_update) over "
          f"both: {render_launches['ga_step']} (want {want})", flush=True)
    check(render_launches["ga_step"] == want, f"the GA took "
          f"{render_launches['ga_step']} steps where Python sees them, want "
          f"{want}")
    fwd_cases, render_in = check_composite_kernel(stt, scene, dev)
    from starst3r_tpu_torch.alignment import ga
    data, mst, ga_cfg = ga_calls[0].args[:3]
    data512, mst512, _, cfg512 = ga512_inputs()
    points = {"main": ga.make_state(data, mst, ga_cfg, device=dev),
              "512px": ga.make_state(data512, mst512, cfg512, device=dev)}
    gathers, ten = ga_gather_phase(points, dev)
    gather_rows = dict(gathers["main"], at_512px={
        k: gathers["512px"][k] for k in ("ms", "library_ms", "autograd_ms",
                                          "bytes", "ops", "gathers")})
    if args.parent_csrc:
        t = time.perf_counter()
        ga_side_by_side(args.parent_csrc, points, dev)
        ten["side_by_side"] = time.perf_counter() - t
    del points
    t = time.perf_counter()
    eight, ga_loss_cases, ga_step_cases = ga_graph_phase(ga_calls[0], dev)
    eight["slice8"] = time.perf_counter() - t
    print("[stages] slice 8: " + " ".join(f"{k}={v:.3f}s"
                                          for k, v in eight.items()),
          flush=True)
    secs512, ga_loss_shapes, ga_step_shapes = ga512_phase(dev)
    ten.update(secs512)
    print("[stages] slice 10: " + " ".join(f"{k}={v:.3f}s"
                                           for k, v in ten.items()),
          flush=True)
    vggt_phase(dev)
    del ga_calls

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
    check(train_launches["gather_rows_bwd"]
          == train_launches["composite_bwd_packed"], "training launched the "
          f"row sum {train_launches['gather_rows_bwd']} times, K2 "
          f"{train_launches['composite_bwd_packed']}")
    check(train_launches["gather_entries"] == 0
          and after_launches["gather_entries"] == 0,
          "training or the renders after it launched the standalone gather")
    check_outputs(scene, orig_t, novel_t, N_VIEWS, HW, N_NOVEL)
    print(f"[render] after training, mean alpha: original views "
          f"{float(orig_t[1].mean()):.4f}, novel views "
          f"{float(novel_t[1].mean()):.4f}", flush=True)
    repeat_s = repeat_phase("224 px", scene, REPEAT_STEPS, probe=True)
    print(f"[stages] slice 13: repeat={repeat_s:.3f}s", flush=True)

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
    parts = packed_bwd_parts(real["x"], run_fwd(real["x"], "packed"),
                             real["g_rgb"], real["g_alpha"], "224 px")
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

    # slice 9: the Blender add-on's command, and the JAX spellings
    torch.cuda.empty_cache()
    nine = blender_phase(os.path.join(work.name, "model.npz"), work.name)
    nine.update(spellings_phase(stt, model, views, scene, cache_dir,
                                work.name))
    print("[stages] slice 9: " + " ".join(f"{k}={v:.3f}s"
                                          for k, v in nine.items()),
          flush=True)
    work.cleanup()
    six.update(planted_ga_phase(dev))
    six.update(turntable_phase())
    print("[stages] slice 6: " + " ".join(f"{k}={v:.3f}s"
                                          for k, v in six.items())
          + "; k2-margin: " + " ".join(f"{k}={v:.3g}"
                                       for k, v in margin.items()),
          flush=True)

    # slice 12: the main path on 4:3 photos at the checkpoint's 512 px
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_res512_") as res_dir:
        twelve, at_res512 = res512_phase(stt, model, dev, res_dir,
                                         args.res512_record)
    print("[stages] slice 12: " + " ".join(f"{k}={v:.3f}s"
                                           for k, v in twelve.items()),
          flush=True)

    kernels_line = []
    # K1's and K2's rows are their packed routes, the functions the main
    # path launches. composite_bwd's error is the scaled one its tolerance
    # is stated in: per attribute, max |kernel - plain| over the plain
    # version's largest magnitude (the conic gradients of the trained scene
    # reach 1e11); its ms is the whole packed backward a training step
    # launches, and `parts` times its pieces: K2 with the zero fill of its
    # per-slot gradient, the CSR and the row sum. The gather's row is the
    # standalone kernel, which the main path no longer launches. The
    # row-gather backward is not a Pallas
    # kernel. At the GA's site (`gather_rows_bwd`) it replaces the TPU
    # route of the JAX `_gather_rows_bwd`; its launches are step 2's (the
    # GA's warm-up steps and captures) and its times the six gather sites'
    # of `[ga-gather]`, summed. At the packed backward's site
    # (`gather_rows_bwd_packed`) it sums K2's per-slot gradient into the
    # table, the JAX `_gather_packed_bwd`; its launches are the training's
    # (one a K2 launch) and its times `[k2-parts]`'.
    bwd_cases[0]["parts"] = {k: v for k, v in parts.items()
                             if k != "row_sum"}
    rows = (("composite_fwd", "composite_fwd_packed",
             "starst3r_tpu/splat/pallas_composite.py:107", fwd_cases[0],
             max(c["max_abs_err"] for c in fwd_cases), None,
             train_launches["composite_fwd_packed"],
             par_launches["composite_fwd_packed"]),
            ("composite_bwd", "composite_bwd_packed",
             "starst3r_tpu/splat/pallas_composite.py:159", bwd_cases[0],
             max(c["scaled_err"] for c in bwd_cases), None,
             train_launches["composite_bwd_packed"],
             par_launches["composite_bwd_packed"]),
            ("gather_entries", "gather_entries",
             "tools/probe_mosaic_gather.py:69", gather,
             gather["max_abs_err"], gather["library_ms"],
             train_launches["gather_entries"],
             par_launches["gather_entries"]),
            ("gather_rows_bwd", "gather_rows_bwd",
             "starst3r_tpu/alignment/ga.py:315", gather_rows,
             gather_rows["max_abs_err"], gather_rows["library_ms"],
             render_launches["gather_rows_bwd"], 0),
            ("ga_loss", "ga_loss",
             "none (the jnp losses of starst3r_tpu/alignment/ga.py:360-417)",
             dict(ga_loss_cases[1], phase2=ga_loss_cases[2],
                  at_shapes=ga_loss_shapes),
             max(c["max_abs_err"] for c in ga_loss_cases.values()), None,
             render_launches["ga_loss"], par_launches["ga_loss"]),
            ("ga_step", "ga_step",
             "none (the JAX step: _make_K_cam_depth, jax.grad, optax's "
             "Adam in starst3r_tpu/alignment/ga.py)",
             step_row(ga_step_cases, ga_step_shapes),
             max(ga_step_cases[p]["in_order_err"] for p in (1, 2)), None,
             render_launches["ga_step"], par_launches["ga_step"]),
            ("gather_rows_bwd_packed", "gather_rows_bwd",
             "starst3r_tpu/splat/rasterize.py:368", parts["row_sum"],
             parts["row_sum"]["max_abs_err"],
             parts["row_sum"]["library_ms"],
             train_launches["gather_rows_bwd"],
             par_launches["gather_rows_bwd"]))
    for (name, function, replaces, case, err, library_ms, launches,
         launches_parallel) in rows:
        bound_ms, bound_by = bound(case["bytes"], case["ops"])
        walked_ms, _ = bound(case["bytes"], case.get("ops_walked", 0))
        pairs = case.get("pairs", {})
        kernels_line.append({
            "name": name, "route": "cuda",
            "source": f"starst3r_tpu_torch/csrc/{function}.cu"
            if function == "gather_rows_bwd" else
            f"starst3r_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "launches_parallel": launches_parallel,
            "max_abs_err": err, "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "function": function, "ms_events": case.get("ms_events"),
            "bytes_sector": case.get("bytes_sector", case["bytes"]),
            "bound_ms_walked": walked_ms,
            "pairs_walked": pairs.get("walked"),
            "pairs_in_boxes": pairs.get("in_boxes"),
            "pairs_passing": pairs.get("passing"),
            "at_res512": at_res512.get(name),
            **({key: case[key] for key in ("autograd_ms", "gathers",
                                             "at_512px")}
               if "gathers" in case else {}),
            **({key: case[key] for key in ("parts", "plan", "phase2",
                                             "at_shapes") if key in case})})
        plain_ms = case["plain_ms"]
        print(f"[kernel] {name} ({function}): {case['ms']:.4f} ms, plain "
              f"{'none' if plain_ms is None else round(plain_ms, 4)} ms, "
              f"library "
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
    # the attention kernel's launches are the main path's (its forwards in
    # add_images), and the sharded training's, which runs no forward
    kernels_line.append(dict(
        attention_row, launches=render_launches["rope_attention"],
        launches_parallel=par_launches["rope_attention"]))
    # the rotation's: MASt3R's main path and sharded training launch none;
    # a Fast3R forward's (`[rope-attn]`) are under launches_fast3r
    kernels_line.append(dict(
        rotate_row, launches=render_launches["rope_rotate"],
        launches_parallel=par_launches["rope_rotate"]))
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
