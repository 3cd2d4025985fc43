"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the compositing forward (`composite_fwd.cu`) and backward
(`composite_bwd.cu`), on both routes (the gathered entries, and the
rasterizer's packed route, which stages each entry's row through the
binning's index and stores each slot's gradient, which the row-sum kernel
sums into the table in a fixed order), the entry gather
(`gather_entries.cu`), and a training step on the card against the same
step on the CPU. Also the stock-PyTorch stages that must run in full
float32 on the card: the LM and Schur polish and the GA with spectral
low-rank depth, each on the card against the same call on the CPU; and the
scene and model checkpoints, round trips on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): each is
marked `cuda` and skips when `torch.cuda.is_available()` is false. The file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances:
  - forward 1e-4, the Pallas forward's own tolerance against its oracle
    (tests/test_pallas_composite.py). The kernel multiplies transmittance
    sequentially where the plain version takes chunked cumulative products,
    so the two differ by float32 rounding only;
  - backward: each attribute's gradient divided by the largest magnitude of
    the plain version's agrees to 2e-3 (the Pallas backward's own
    tolerance). The kernel walks the batches front to back with the
    forward's own running product T *= 1 - alpha and takes each entry's
    suffix sum as the forward's rgb minus the colour accumulated so far,
    which cancels to about 1e-7 of |rgb|; the plain version runs every
    batch where the kernel stops at the forward's early exit (those terms
    are below T = 1e-6);
  - the gather: exact;
  - the packed forward against the entries route on the entries the
    gather gives: bit for bit (the same walk and arithmetic, only the
    staging differs); the packed backward's per-slot gradient against the
    entries route's: bit for bit; its table against
    `_gather_rows_bwd_in_order` of that gradient (the row-sum kernel's
    order in PyTorch): bit for bit; against ``index_add_`` of the entries
    route's gradient: 1e-6 of each attribute's largest value (the same
    per-entry sums, added into the rows in another order);
  - determinism: two launches of the packed backward, two `run_optim`
    runs of 30 steps with an MCMC refine from one state, three MCMC
    categorical draws at a pool's size from one generator state, two
    builds of the polish's systems and two whole `lm_refine` and
    `schur_refine` runs give the same bits (no float atomics on these
    paths);
  - a training step on the card against the CPU: the loss to 1e-4
    relative (other summation orders, and the kernels' own rounding), and
    each parameter's gradient (Adam's first moment after one step, 0.1
    times the gradient) within 2e-3 of the CPU's largest magnitude, the
    backward kernel's own tolerance;
  - the polish on the card against the CPU, on planted problems (the
    construction of tests/test_lm.py and tests/test_schur.py): the normal
    equations and the Schur system at the perturbed start within 1e-5 of
    their largest entry (the same products, added in another order: the
    row-sum kernel's on the card, index_add_'s on the CPU), the cost to
    1e-5 relative; the refined poses within 1e-3 of
    the CPU's, and the JAX tests' own bounds against the planted poses
    (1e-2 LM, 2e-2 Schur; the cost below 1e-4 of the first). The cost
    sequences are not compared: the damped system's condition number
    reaches ~1e7 (each quaternion's radial direction is held only by the
    damping), so float32 sums in another order move the first steps by a
    few percent (the CPU's float32 and float64 sequences differ by 0.6%
    at the first step);
  - the lora GA on the card against the CPU on a planted sphere scene:
    1e-4, tests/test_torch_ga.py's tolerance, poses in the root camera's
    frame (the GA's free rigid motion);
  - the row-sum kernel (`csrc/gather_rows_bwd.cu`) against its
    plain version ``index_add_`` summed in float64 on the card, at the six
    gather sites' shapes, on a row of 368,640 entries (split over a
    cluster of blocks) and on odd widths: 1e-5 (1 + max|plain|) (float32
    sums in another order; the kernel has no atomics); bit for bit against
    `_gather_rows_bwd_in_order`, its own summation order in PyTorch; empty
    rows exactly 0; two launches, and a launch replayed in a CUDA graph,
    equal to the eager launch bit for bit;
  - the GA's fused losses (`csrc/ga_loss.cu`) at four shapes (the 4-camera
    scene, the 512 px operating point, six views of 224 x 160 and of
    512 x 384): the loss and the gradients (K, cam2w, proj, depth) against
    `ga_loss_in_order`, the kernel's order in PyTorch on the card, within
    1e-6 (relative, and of each gradient's largest magnitude: the same
    arithmetic, libdevice's powf against PyTorch's pow), and against
    autograd of the losses' plain chain on the card with respect to the
    same tensors, the loss to 1e-6 relative and each gradient within 1e-4
    of its largest magnitude and no farther from the chain in float64 (on
    the CPU) than twice the float32 chain's distance; two launches, and a
    launch replayed in a CUDA graph, equal bit for bit; one call a GA
    step;
  - the GA step's kernels (`csrc/ga_step.cu`: the reparameterisation, its
    backward with the masked Adam) against their order in PyTorch on the
    card, fed the same fused loss's output, on the CPU tests' cases (both
    phases; frozen cameras, shared intrinsics, exp depth, the "mul" depth
    mode, the lora basis, opt_pp off) and at the recon cells' shapes:
    within 1e-6 of each output's largest magnitude (libdevice's
    transcendentals, compiled with -fmad=false, against PyTorch's); two
    steps, and a step replayed in a CUDA graph, equal bit for bit; a
    replayed step launching at most 6 kernels; the whole GA on the card
    against the CPU's with and without lora, frozen cameras, shared
    intrinsics and the "mul" mode at the lora test's 1e-4;
  - the GA's captured step replayed on the card against the same step run
    eagerly on the card, on a small scene and at the JAX package's 512 px
    operating point: poses in the root frame, K, depth and the phase
    losses, each scaled by its largest magnitude, within twice the
    distance of two eager runs from each other, never below 1e-6;
  - checkpoints: bit for bit;
  - the command line (`python -m starst3r_tpu_torch`) on the card at the
    tiny preset: every subcommand exits 0 and writes its files, and the
    subcommands that render or train launch the packed compositing kernels;
    `utils.profiling.trace_if` writes a trace.
  - `parallel.initialize_distributed`: two processes asking for NCCL on
    one card both raise (no other backend is taken in its place);
  - on a machine with several cards, the sharded paths over NCCL (one rank
    per card) against the meshless calls on one card, with the CPU tests'
    tolerances (tests/test_torch_parallel.py); skips on one card;
  - the JAX spellings on the card: `rasterize(..., impl="auto")` equal to
    the default call with K1 launched (the JAX backends raise),
    `native.build(force=True)` building the library anew, and a kernel
    built under `utils.enable_compilation_cache`'s directory;
  - MASt3R's attention kernel (`csrc/rope_attention.cu`) against float64
    attention on q and k rotated by `apply_rope_2d` (which the kernel's
    rotation equals bit for bit) and v: in bfloat16 within
    FUSED_ATTN_TOL of the largest magnitude (its output rounds by 2^-9 of
    a value, and P rounds to bfloat16 as the PV product's operand) and no
    farther than twice the plain version (`apply_rope_2d` then `sdpa`,
    which rounds the scores to bfloat16 before the softmax) plus 1e-3 of
    the largest magnitude; in float32 within ROPE_ATTN_F32_TOL of the
    largest magnitude (float32 sums in another order, exp2f's ulps), the
    rect test's network bound.
"""

import numpy as np
import pytest
import torch

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.config import SplatConfig
from starst3r_tpu_torch.ops import row_sum
from starst3r_tpu_torch.splat import composite as comp
from starst3r_tpu_torch.splat import gather as gat
from starst3r_tpu_torch.splat import train as train_mod
from torch_attention_cases import attention_f64, attention_inputs
from starst3r_tpu_torch.splat.rasterize import (_project_and_bin,
                                                bin_gaussians, rasterize,
                                                tile_entries)

pytestmark = pytest.mark.cuda

ATOL = 1e-4
BWD_SCALED_TOL = 2e-3
PACKED_SCALED_TOL = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(n=96, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    means[:, 2] += 2.5
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = rng.uniform(0.01, 0.08, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    sh = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.3
    w2c = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    w2c[1, 0, 3] = 0.15
    K = np.tile(np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]],
                         np.float32)[None], (2, 1, 1))
    return [torch.from_numpy(a) for a in (means, quats, scales, opac, sh,
                                          w2c, K)]


def _wall(n=600, seed=0):
    rng = np.random.default_rng(seed)
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = np.linspace(1.0, 5.0, n)
    means[:, :2] = rng.normal(size=(n, 2)) * 0.01
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 2.0, np.float32)
    opac = np.full((n,), 0.999, np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0] = rng.normal(size=(n, 3))
    w2c = np.eye(4, dtype=np.float32)[None]
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)[None]
    return [torch.from_numpy(a) for a in (means, quats, scales, opac, sh,
                                          w2c, K)]


def _compare(ent, counts, h, w, tile, tw, th, dev):
    """Kernel and plain version on the card, on the same tensors."""
    ent = ent.to(dev).contiguous()
    counts = counts.to(dev).contiguous()
    rgb_p, a_p = comp.composite_tiles_plain(ent, counts, h, w, tile, tw, th)
    before = comp.composite_tiles_cuda.launches
    rgb_k, a_k, tfin, done = comp.composite_tiles_cuda(ent, counts, h, w,
                                                       tile, tw, th)
    torch.cuda.synchronize()
    assert comp.composite_tiles_cuda.launches == before + 1
    np.testing.assert_allclose(rgb_k.cpu().numpy(), rgb_p.cpu().numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(a_k.cpu().numpy(), a_p.cpu().numpy(),
                               atol=ATOL)
    counts = counts.cpu()
    c, t = counts.shape
    assert tfin.shape == (c * t, tile * tile) and done.shape == (c * t,)
    batches = (counts.reshape(-1).long() + 127) // 128
    assert bool((done.cpu().long() <= batches).all())
    return tfin.cpu(), done.cpu()


CASE_KW = {"scene": dict(max_tiles_per_gaussian=9, max_per_tile=128),
           "wall": dict(max_tiles_per_gaussian=9, max_per_tile=1024),
           "multichunk": dict(max_tiles_per_gaussian=4, max_per_tile=512)}
ANY_SHAPES = [(16, 40, 24, 200), (8, 20, 36, 64), (16, 224, 224, 128),
              (32, 40, 50, 96), (16, 384, 512, 128)]


def _case_args(case):
    return {"scene": _scene, "wall": _wall,
            "multichunk": lambda: _scene(n=1400)}[case]()


def _case_entries(case):
    kw = CASE_KW[case]
    return tile_entries(*_case_args(case), 32, 32, 1, 16,
                        kw["max_tiles_per_gaussian"], kw["max_per_tile"])[:2]


def _random_entries(tile, h, w, k):
    """Random entries of 3 cameras for an h x w image, with empty tiles."""
    rng = np.random.default_rng(tile + h + k)
    tw, th = -(-w // tile), -(-h // tile)
    c, t = 3, tw * th
    counts = rng.integers(0, k + 1, size=(c, t)).astype(np.int32)
    counts[0, 0] = 0
    ent = np.zeros((c, t, k, 9), np.float32)
    for ci in range(c):
        for ti in range(t):
            m = counts[ci, ti]
            x0, y0 = (ti % tw) * tile, (ti // tw) * tile
            ent[ci, ti, :m, 0] = rng.uniform(x0 - 4, x0 + tile + 4, m)
            ent[ci, ti, :m, 1] = rng.uniform(y0 - 4, y0 + tile + 4, m)
            ent[ci, ti, :m, 2] = rng.uniform(0.05, 0.5, m)
            ent[ci, ti, :m, 3] = rng.uniform(-0.02, 0.02, m)
            ent[ci, ti, :m, 4] = rng.uniform(0.05, 0.5, m)
            ent[ci, ti, :m, 5:8] = rng.uniform(0, 1, (m, 3))
            ent[ci, ti, :m, 8] = rng.uniform(0.05, 0.99, m)
    return torch.from_numpy(ent), torch.from_numpy(counts), tw, th


def _degenerate_entries():
    """Near-singular conics (a*c ~ b^2): sigma within rounding of 0 along
    a line of pixels, where the sigma < 0 cull jumps from an opaque splat
    to none."""
    rng = np.random.default_rng(9)
    tile, tw, th, k = 16, 2, 2, 256
    counts = np.full((1, 4), k, np.int32)
    ent = np.zeros((1, 4, k, 9), np.float32)
    for ti in range(4):
        x0, y0 = (ti % tw) * tile, (ti // tw) * tile
        # means a fraction of a pixel off pixel centres, on dx == dy lines
        off = rng.uniform(-0.3, 0.3, k)
        ent[0, ti, :, 0] = x0 + rng.integers(0, tile, k) + 0.5 + off
        ent[0, ti, :, 1] = y0 + rng.integers(0, tile, k) + 0.5 + off
        s = rng.uniform(1e2, 1e4, k)
        ent[0, ti, :, 2] = s
        ent[0, ti, :, 3] = -s * rng.uniform(0.999999, 1.0, k)
        ent[0, ti, :, 4] = s
        ent[0, ti, :, 5:8] = rng.uniform(0, 1, (k, 3))
        ent[0, ti, :, 8] = 1.0
    return torch.from_numpy(ent), torch.from_numpy(counts)


def _compare_bwd(ent, counts, h, w, tile, tw, th, dev, seed=0,
                 tol=(BWD_SCALED_TOL,) * 9):
    """Backward kernel and its plain version on the card, on the forward
    kernel's tfin/done and random pixel gradients; ``tol`` per attribute."""
    ent = ent.to(dev).contiguous()
    counts = counts.to(dev).contiguous()
    c = ent.shape[0]
    rgb, _, tfin, done = comp.composite_tiles_cuda(ent, counts, h, w, tile,
                                                   tw, th)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g_rgb = torch.randn((c, h, w, 3), generator=gen, device=dev)
    g_alpha = torch.randn((c, h, w), generator=gen, device=dev)
    before = comp.composite_tiles_bwd_cuda.launches
    got = comp.composite_tiles_bwd_cuda(ent, counts, rgb, tfin, done, g_rgb,
                                        g_alpha, h, w, tile, tw, th)
    torch.cuda.synchronize()
    assert comp.composite_tiles_bwd_cuda.launches == before + 1
    want = comp.composite_tiles_bwd_plain(ent, counts, done, g_rgb, g_alpha,
                                          h, w, tile, tw, th)
    assert bool(torch.isfinite(got).all())
    for a in range(9):
        scale = max(float(want[..., a].abs().max()), 1e-6)
        err = float((got[..., a] - want[..., a]).abs().max()) / scale
        assert err <= tol[a], (a, err)
    # slots past the forward's batches are untouched zeros
    k = ent.shape[2]
    past = (torch.arange(k, device=dev)
            >= done.reshape(c, -1, 1).long() * comp.BATCH)
    if bool(past.any()):
        assert float(got[past].abs().max()) == 0.0
    return got


@pytest.mark.parametrize("case", ["scene", "wall", "multichunk"])
def test_kernel_matches_plain(dev, case):
    ent, counts = _case_entries(case)
    tfin, done = _compare(ent, counts, 32, 32, 16, 2, 2, dev)
    if case == "wall":
        # every tile saturates in its first batch and stops there
        assert bool((done == 1).all()) and int(counts.min()) > 128
        assert float(tfin.max()) <= 1e-6
    if case == "multichunk":
        assert int(counts.max()) > 128 and int(done.max()) > 1


@pytest.mark.parametrize("tile,h,w,k", ANY_SHAPES)
def test_kernel_any_shape(dev, tile, h, w, k):
    """Any camera count, tile count and K (no multiple-of-128 or tile-group
    preconditions), ragged image edges, empty tiles."""
    ent, counts, tw, th = _random_entries(tile, h, w, k)
    _compare(ent, counts, h, w, tile, tw, th, dev)


def test_kernel_degenerate_conics(dev):
    """The kernel must round sigma as the plain version does, or the
    sigma < 0 cull decides otherwise."""
    ent, counts = _degenerate_entries()
    _compare(ent, counts, 32, 32, 16, 2, 2, dev)


@pytest.mark.parametrize("case", ["scene", "wall", "multichunk"])
def test_bwd_kernel_matches_plain(dev, case):
    ent, counts = _case_entries(case)
    _compare_bwd(ent, counts, 32, 32, 16, 2, 2, dev)


@pytest.mark.parametrize("tile,h,w,k", ANY_SHAPES)
def test_bwd_kernel_any_shape(dev, tile, h, w, k):
    """Ragged edges, empty tiles, tiles of 64 threads and of 1024 (whose
    per-warp sums take more than 48 KB of shared memory)."""
    ent, counts, tw, th = _random_entries(tile, h, w, k)
    _compare_bwd(ent, counts, h, w, tile, tw, th, dev, seed=tile + k)


def test_bwd_kernel_degenerate_conics(dev):
    """The backward culls exactly the entries the forward culled: the
    colour, opacity and conic gradients agree to 2e-3. The mean gradients
    of these entries are ill-conditioned: a dx + b dy, with b = -a (1 - 1e-6)
    and dx close to dy, cancels to 1e-6 of its terms, so float32 rounding
    alone moves both versions by up to about a tenth of the largest value;
    they are held to 0.2."""
    ent, counts = _degenerate_entries()
    _compare_bwd(ent, counts, 32, 32, 16, 2, 2, dev,
                 tol=(0.2, 0.2) + (BWD_SCALED_TOL,) * 7)


def _small_splats(seed, k=512, opaque=False):
    """Many splats per tile of 2 to 10 pixels each (radius 0.8 to 1.8 px
    at the culls' threshold, some slanted), so most warps skip most
    entries. ``opaque`` ones (opacity 0.999, K entries in every tile, each
    within 0.02 px of a pixel centre: every pixel once in a random order,
    then again) drive the tiles to the early exit."""
    rng = np.random.default_rng(seed)
    tile, tw, th = 16, 2, 2
    t = tw * th
    counts = (np.full((2, t), k, np.int32) if opaque else
              rng.integers(k // 2, k + 1, size=(2, t)).astype(np.int32))
    ent = np.zeros((2, t, k, 9), np.float32)
    shape = (2, t, k)
    ti = np.arange(t)[None, :, None]
    if opaque:
        pix = np.concatenate([rng.permuted(np.tile(
            np.arange(tile * tile), (2, t, 1)), axis=-1)
            for _ in range(k // (tile * tile))], axis=-1)
        local_x = pix % tile + 0.5 + rng.uniform(-0.02, 0.02, shape)
        local_y = pix // tile + 0.5 + rng.uniform(-0.02, 0.02, shape)
    else:
        local_x = rng.uniform(-1, tile + 1, shape)
        local_y = rng.uniform(-1, tile + 1, shape)
    ent[..., 0] = (ti % tw) * tile + local_x
    ent[..., 1] = (ti // tw) * tile + local_y
    op = np.full(shape, 0.999) if opaque else rng.uniform(0.3, 0.99, shape)
    rad = rng.uniform(0.8, 1.8, shape)
    a = 2.0 * np.log(255.0 * op) / rad ** 2
    ent[..., 2] = a
    ent[..., 3] = rng.uniform(-0.3, 0.3, shape) * a
    ent[..., 4] = a * rng.uniform(0.7, 1.3, shape)
    ent[..., 5:8] = rng.uniform(0, 1, shape + (3,))
    ent[..., 8] = op
    past = np.arange(k)[None, None] >= counts[..., None]
    ent[past] = 0.0
    return torch.from_numpy(ent), torch.from_numpy(counts)


def _check_done(ent, counts, done, tile, tw, th):
    """The early exit processed the batches the plain transmittance asks
    for, in every tile not within rounding of the threshold."""
    want, near = comp.done_plain(ent.cpu(), counts.cpu(), tile, tw, th)
    ok = (done.long() == want) | near
    assert bool(ok.all()), (done[~ok], want[~ok])


@pytest.mark.parametrize("opaque", [False, True],
                         ids=["translucent", "opaque"])
def test_kernels_small_splats(dev, opaque):
    """Splats of a few pixels, where each warp walks few of a batch's
    entries: the forward within 1e-4 of plain with the plain early exit,
    the backward within 2e-3 scaled."""
    ent, counts = _small_splats(11 + opaque, k=1024 if opaque else 512,
                                opaque=opaque)
    box = comp.cull_boxes_plain(ent, 16, 2, 2)
    area = ((box[..., 1] - box[..., 0] + 1) * (box[..., 3] - box[..., 2] + 1)
            * (box[..., 0] <= box[..., 1]))
    assert float(area.float().mean()) < 40          # small boxes
    _, done = _compare(ent, counts, 32, 32, 16, 2, 2, dev)
    _check_done(ent, counts, done, 16, 2, 2)
    if opaque:
        assert int(done.max()) < 8                  # the exit fired
    _compare_bwd(ent, counts, 32, 32, 16, 2, 2, dev, seed=3)


def _adversarial_entries():
    """Small splats mixed, slot by slot, with near-degenerate conics,
    non-finite means and conics, NaN opacities, and splats far off the tile
    (1e6 px away): every box rule at once."""
    ent, counts = _small_splats(21, k=384)
    e = ent.numpy().copy()
    rng = np.random.default_rng(22)
    kind = rng.integers(0, 4, size=e.shape[:3])
    live = np.arange(e.shape[2])[None, None] < counts.numpy()[..., None]
    degen = (kind == 1) & live
    s = rng.uniform(1e2, 1e4, int(degen.sum()))
    e[degen, 2] = s
    e[degen, 3] = -s * rng.uniform(0.999999, 1.0, s.size)
    e[degen, 4] = s
    bad = (kind == 2) & live
    attr = rng.choice([0, 1, 2, 3, 4, 8], size=int(bad.sum()))
    vals = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32),
                      size=attr.size)
    vals[attr == 8] = np.nan        # an infinite opacity would fill a tile
    rows = np.argwhere(bad)
    e[rows[:, 0], rows[:, 1], rows[:, 2], attr] = vals
    far = (kind == 3) & live
    e[far, 0] += rng.choice([-1e6, 1e6], int(far.sum()))
    return torch.from_numpy(e), counts, torch.from_numpy(bad)


def test_kernels_adversarial_entries(dev):
    """Degenerate, non-finite and far-away entries among ordinary ones: the
    forward within 1e-4 of plain with the plain early exit; the backward
    finite, zero for the entries with a non-finite attribute (culled at
    every pixel), and within 2e-3 scaled of plain elsewhere (the plain
    version's autograd gives those entries NaN: 0 times a NaN falloff).
    The mean gradients of degenerate conics cancel to 1e-6 of their terms
    and are held to 0.2, as in test_bwd_kernel_degenerate_conics."""
    ent, counts, bad = _adversarial_entries()
    _, done = _compare(ent, counts, 32, 32, 16, 2, 2, dev)
    _check_done(ent, counts, done, 16, 2, 2)
    e, cnt = ent.to(dev), counts.to(dev)
    rgb, _, tfin, done = comp.composite_tiles_cuda(e, cnt, 32, 32, 16, 2, 2)
    gen = torch.Generator(device=dev).manual_seed(5)
    g_rgb = torch.randn((2, 32, 32, 3), generator=gen, device=dev)
    g_alpha = torch.randn((2, 32, 32), generator=gen, device=dev)
    got = comp.composite_tiles_bwd_cuda(e, cnt, rgb, tfin, done, g_rgb,
                                        g_alpha, 32, 32, 16, 2, 2).cpu()
    want = comp.composite_tiles_bwd_plain(e, cnt, done, g_rgb, g_alpha, 32,
                                          32, 16, 2, 2).cpu()
    assert bool(torch.isfinite(got).all())
    assert float(got[bad].abs().max()) == 0.0
    keep = ~bad
    assert bool(torch.isfinite(want[keep]).all())
    for a, tol in enumerate((0.2, 0.2) + (BWD_SCALED_TOL,) * 7):
        scale = max(float(want[keep][:, a].abs().max()), 1e-6)
        err = float((got[keep][:, a] - want[keep][:, a]).abs().max()) / scale
        assert err <= tol, (a, err)


@pytest.mark.parametrize("n_full", [1, 3])
def test_kernels_partial_last_batch(dev, n_full):
    """128 * n + 1 entries in a tile, in a K that is not a multiple of 4
    (unaligned batches, staged 4 bytes at a time): the double buffer's last
    batch holds one entry; tiles of 129 and 1 entries beside it."""
    k = 128 * n_full + 1
    ent, counts = _small_splats(31 + n_full, k=k)
    counts = counts.clone()
    counts[0, 0], counts[0, 1], counts[1, 0], counts[1, 1] = k, 129, 1, 0
    live = torch.arange(k)[None, None] < counts[..., None]
    ent = ent * live[..., None]
    _, done = _compare(ent, counts, 32, 32, 16, 2, 2, dev)
    _check_done(ent, counts, done, 16, 2, 2)
    assert int(done[0]) == n_full + 1 and int(done[1]) == 2
    _compare_bwd(ent, counts, 32, 32, 16, 2, 2, dev, seed=n_full)


@pytest.mark.parametrize("tile,h,w,k", [(12, 30, 40, 200),
                                         (20, 44, 37, 160)])
def test_kernels_tile_not_multiple_of_footprint(dev, tile, h, w, k):
    """Tiles of 12 and 20 pixels: the 8x4 warp footprints overhang the
    tile, and their phantom lanes take no part in the early exit and write
    nothing."""
    ent, counts, tw, th = _random_entries(tile, h, w, k)
    _, done = _compare(ent, counts, h, w, tile, tw, th, dev)
    _check_done(ent, counts, done, tile, tw, th)
    _compare_bwd(ent, counts, h, w, tile, tw, th, dev, seed=tile)


def test_composite_autograd_launches_both_kernels(dev):
    """CompositeTiles (entries route) and CompositePacked (packed route)
    each launch their forward and backward kernel once, and the packed
    route's gradient is the index_add_ of the entries route's."""
    packed, gidx, valid, counts, _ = _project_and_bin(
        *[a.to(dev) for a in _case_args("multichunk")], 32, 32, 1, 16,
        **_bin_kw("multichunk"))
    ent = gat.gather_entries_plain(packed, gidx, valid)
    e = ent.detach().requires_grad_(True)
    p = packed.detach().requires_grad_(True)
    launches = (comp.composite_tiles_cuda.launches,
                comp.composite_tiles_bwd_cuda.launches,
                comp.composite_packed_cuda.launches,
                comp.composite_packed_slots_cuda.launches,
                gat.gather_entries_cuda.launches)
    nonfinite = (int(comp.CompositeTiles.nonfinite),
                 int(comp.CompositePacked.nonfinite))
    rgb, alpha = comp.composite_tiles(e, counts, 32, 32, 16, 2, 2)
    (rgb.square().sum() + alpha.sum()).backward()
    rgb_p, alpha_p = comp.composite_packed(p, gidx, counts, 32, 32, 16, 2, 2)
    (rgb_p.square().sum() + alpha_p.sum()).backward()
    torch.cuda.synchronize()
    assert (comp.composite_tiles_cuda.launches,
            comp.composite_tiles_bwd_cuda.launches,
            comp.composite_packed_cuda.launches,
            comp.composite_packed_slots_cuda.launches,
            gat.gather_entries_cuda.launches) == tuple(
                x + 1 for x in launches[:4]) + launches[4:]
    assert e.grad.shape == e.shape and bool(torch.isfinite(e.grad).all())
    assert p.grad.shape == p.shape and bool(torch.isfinite(p.grad).all())
    assert (int(comp.CompositeTiles.nonfinite),
            int(comp.CompositePacked.nonfinite)) == nonfinite
    assert torch.equal(rgb_p, rgb) and torch.equal(alpha_p, alpha)
    want = torch.zeros_like(packed).index_add_(
        0, gidx.reshape(-1), (e.grad * valid[..., None]).reshape(-1, 9))
    _assert_packed_grad(p.grad, want)


def test_gather_matches_indexing(dev):
    """The gather kernel equals ``packed[gidx] * ent_valid`` exactly, and
    its index_add backward equals autograd through the indexing."""
    args = [a.to(dev) for a in _scene(n=1400)]
    bins = bin_gaussians(*args, 32, 32, 1, 16, 4, 512)
    n_rows = 2 * 1400
    gen = torch.Generator(device=dev).manual_seed(0)
    packed = torch.randn((n_rows, 9), generator=gen, device=dev)
    before = gat.gather_entries_cuda.launches
    got = gat.gather_entries_cuda(packed, bins.gidx, bins.ent_valid)
    torch.cuda.synchronize()
    assert gat.gather_entries_cuda.launches == before + 1
    want = gat.gather_entries_plain(packed, bins.gidx, bins.ent_valid)
    assert torch.equal(got, want)
    cot = torch.randn(got.shape, generator=gen, device=dev)
    p1 = packed.clone().requires_grad_(True)
    (g1,) = torch.autograd.grad(gat.gather_entries(p1, bins.gidx,
                                                   bins.ent_valid), p1, cot)
    p2 = packed.clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(gat.gather_entries_plain(
        p2, bins.gidx, bins.ent_valid), p2, cot)
    np.testing.assert_allclose(g1.cpu().numpy(), g2.cpu().numpy(),
                               atol=1e-5)


def _bin_kw(case):
    kw = CASE_KW[case]
    return dict(max_tiles_per_gaussian=kw["max_tiles_per_gaussian"],
                max_per_tile=kw["max_per_tile"], bins=None)


def _as_packed(ent, counts, seed=0):
    """A (C*T*K + 7, 9) table whose rows, read through gidx at the slots
    below each tile's count, are the entries, in a shuffled order; the
    other slots point at rows of garbage (opaque splats over the whole
    tile), which a kernel that reads past a count would composite."""
    rng = np.random.default_rng(seed)
    c, t, k, _ = ent.shape
    rows = c * t * k + 7
    table = np.zeros((rows, 9), np.float32)
    table[:, 0:2] = 8.0
    table[:, 2] = table[:, 4] = 1e-3
    table[:, 5:9] = 0.9
    perm = rng.permutation(rows)[:c * t * k].reshape(c, t, k)
    live = (np.arange(k)[None, None] < counts.numpy()[..., None])
    table[perm[live]] = ent.numpy()[live]
    return torch.from_numpy(table), torch.from_numpy(perm.astype(np.int32))


def _packed_case(case, dev):
    """(packed, gidx, counts, tile, h, w, tw, th) on the card: the binning's
    own for the rasterizer's scenes, a shuffled table for the synthetic
    entries."""
    if case in CASE_KW:
        packed, gidx, _, counts, _ = _project_and_bin(
            *[a.to(dev) for a in _case_args(case)], 32, 32, 1, 16,
            **_bin_kw(case))
        return packed.detach(), gidx, counts, 16, 32, 32, 2, 2
    if case == "empty_tiles":
        ent, counts, tw, th = _random_entries(16, 40, 24, 200)
        tile, h, w = 16, 40, 24
    else:
        tile, h, w, tw, th = 16, 32, 32, 2, 2
        if case == "translucent":
            ent, counts = _small_splats(11, k=512)
        elif case == "opaque":
            ent, counts = _small_splats(12, k=1024, opaque=True)
        elif case == "adversarial":
            ent, counts, _ = _adversarial_entries()
        else:                                   # partial_129, partial_385
            k = int(case.split("_")[1])
            ent, counts = _small_splats(31 + k // 128, k=k)
            counts = counts.clone()
            counts[0, 0], counts[0, 1], counts[1, 0], counts[1, 1] = (
                k, 129, 1, 0)
    packed, gidx = _as_packed(ent, counts)
    return (packed.to(dev), gidx.to(dev), counts.to(dev).contiguous(), tile,
            h, w, tw, th)


PACKED_CASES = ["scene", "wall", "multichunk", "translucent", "opaque",
                "adversarial", "partial_129", "partial_385", "empty_tiles"]


def _assert_packed_grad(got, want):
    assert bool(torch.isfinite(got).all())
    for a in range(9):
        scale = max(float(want[:, a].abs().max()), 1e-12)
        err = float((got[:, a] - want[:, a]).abs().max()) / scale
        assert err <= PACKED_SCALED_TOL, (a, err)


@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_fwd_equals_entries_route(dev, case):
    """The packed route's rgb, alpha, tfin and done equal, bit for bit, the
    entries route's on the entries the gather gives: K of 129 and 385
    (index and row batches that are not 16-byte aligned), empty tiles,
    tiles that stop early, non-finite and degenerate entries, and slots
    past the counts whose indices point at garbage rows."""
    packed, gidx, counts, tile, h, w, tw, th = _packed_case(case, dev)
    ent = gat.gather_entries_plain(packed, gidx,
                                   comp.slot_valid(gidx, counts))
    before = comp.composite_packed_cuda.launches
    got = comp.composite_packed_cuda(packed, gidx, counts, h, w, tile, tw, th)
    want = comp.composite_tiles_cuda(ent, counts, h, w, tile, tw, th)
    torch.cuda.synchronize()
    assert comp.composite_packed_cuda.launches == before + 1
    for name, a, b in zip(("rgb", "alpha", "tfin", "done"), got, want):
        assert torch.equal(a, b), name
    if case in ("wall", "opaque"):
        assert int(got[3].max()) < (int(counts.max()) + 127) // 128


@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_bwd_matches_index_add_of_entries_route(dev, case):
    """The packed backward's grad_packed against index_add_ of the entries
    route's gradient into the table, within 1e-6 of each attribute's
    largest value; rows that no slot below a count points at stay 0."""
    packed, gidx, counts, tile, h, w, tw, th = _packed_case(case, dev)
    valid = comp.slot_valid(gidx, counts)
    ent = gat.gather_entries_plain(packed, gidx, valid)
    rgb, _, tfin, done = comp.composite_tiles_cuda(ent, counts, h, w, tile,
                                                   tw, th)
    c = counts.shape[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    g_rgb = torch.randn((c, h, w, 3), generator=gen, device=dev)
    g_alpha = torch.randn((c, h, w), generator=gen, device=dev)
    grad_e = comp.composite_tiles_bwd_cuda(ent, counts, rgb, tfin, done,
                                           g_rgb, g_alpha, h, w, tile, tw, th)
    want = torch.zeros_like(packed).index_add_(
        0, gidx.reshape(-1), (grad_e * valid[..., None]).reshape(-1, 9))
    before = comp.composite_packed_slots_cuda.launches
    got = comp.composite_packed_bwd_cuda(packed, gidx, counts, rgb, tfin,
                                         done, g_rgb, g_alpha, h, w, tile,
                                         tw, th)
    torch.cuda.synchronize()
    assert comp.composite_packed_slots_cuda.launches == before + 1
    _assert_packed_grad(got, want)
    unused = torch.ones(packed.shape[0], dtype=torch.bool, device=dev)
    unused[gidx[valid].long()] = False
    if bool(unused.any()):
        assert float(got[unused].abs().max()) == 0.0


def test_packed_wrappers_reject_bad_inputs(dev):
    packed = torch.zeros((10, 9), device=dev)
    gidx = torch.zeros((1, 4, 8), dtype=torch.int32, device=dev)
    counts = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    fwd = comp.composite_packed_cuda
    with pytest.raises(ValueError):
        fwd(packed.double(), gidx, counts, 32, 32, 16, 2, 2)
    with pytest.raises(ValueError):
        fwd(packed, gidx.long(), counts, 32, 32, 16, 2, 2)
    with pytest.raises(ValueError):
        fwd(packed, gidx[0], counts, 32, 32, 16, 2, 2)
    with pytest.raises(ValueError):
        fwd(packed, gidx, counts[:, :2], 32, 32, 16, 2, 2)
    with pytest.raises(ValueError):
        fwd(packed[:, :8], gidx, counts, 32, 32, 16, 2, 2)
    rgb = torch.zeros((1, 32, 32, 3), device=dev)
    tfin = torch.ones((4, 256), device=dev)
    done = torch.ones((4,), dtype=torch.int32, device=dev)
    g_a = torch.zeros((1, 32, 32), device=dev)
    bwd = comp.composite_packed_bwd_cuda
    with pytest.raises(ValueError):
        bwd(packed, gidx, counts, rgb, tfin, done.long(), rgb, g_a, 32, 32,
            16, 2, 2)
    with pytest.raises(ValueError):
        bwd(packed, gidx, counts, rgb, tfin, done, rgb, g_a.cpu(), 32, 32,
            16, 2, 2)


def test_train_step_on_cuda_matches_cpu(dev):
    """One train_step on the card (the packed forward and backward
    kernels, no standalone gather) against the same step on the CPU (plain
    versions): the loss, and the gradients that reached Adam, which the
    loss alone does not show."""
    rng = np.random.default_rng(0)
    n, c = 512, 2
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    gt = torch.from_numpy(rng.uniform(size=(c, 32, 32, 3)).astype(
        np.float32))
    w2c = torch.eye(4).repeat(c, 1, 1)
    K = torch.tensor([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]]).repeat(c, 1,
                                                                        1)
    cfg = SplatConfig()
    losses, moments = {}, {}
    launches = (gat.gather_entries_cuda.launches,
                comp.composite_packed_cuda.launches,
                comp.composite_packed_slots_cuda.launches)
    for d in ("cpu", dev):
        state = train_mod.init_gaussians(pts, cols, cfg, device=d)
        state, loss = train_mod.train_step(state, gt.to(d), w2c.to(d),
                                           K.to(d), 32, 32, cfg, c)
        losses[str(d)] = float(loss)
        moments[str(d)] = {k: v.cpu() for k, v in state.opt_state.mu.items()}
        assert all(bool(torch.isfinite(v).all())
                   for v in state.params.values())
    assert (gat.gather_entries_cuda.launches,
            comp.composite_packed_cuda.launches,
            comp.composite_packed_slots_cuda.launches) == (
                launches[0], launches[1] + 1, launches[2] + 1)
    np.testing.assert_allclose(losses[str(dev)], losses["cpu"], rtol=1e-4)
    for k, want in moments["cpu"].items():
        got = moments[str(dev)][k]
        assert bool(torch.isfinite(got).all()), k
        # the quats' gradient is zero at the isotropic start: the floor
        # keeps rounding noise from counting as an error
        scale = max(float(want.abs().max()), 1e-6)
        err = float((got - want).abs().max()) / scale
        assert err <= BWD_SCALED_TOL, (k, err)


def test_rasterize_on_cuda_matches_cpu(dev):
    """The rasterizer on the card goes through the packed forward route
    and launches no standalone gather."""
    args = _scene()
    kw = dict(width=32, height=32, sh_degree=1, tile_size=16,
              max_tiles_per_gaussian=9, max_per_tile=128)
    rgb_c, a_c, info_c = rasterize(*args, **kw)
    before = (comp.composite_packed_cuda.launches,
              gat.gather_entries_cuda.launches,
              comp.composite_tiles_cuda.launches)
    rgb_g, a_g, info_g = rasterize(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    assert (comp.composite_packed_cuda.launches,
            gat.gather_entries_cuda.launches,
            comp.composite_tiles_cuda.launches) == (before[0] + 1,
                                                     before[1], before[2])
    assert rgb_g.is_cuda
    np.testing.assert_allclose(rgb_g.cpu().numpy(), rgb_c.numpy(), atol=ATOL)
    np.testing.assert_allclose(a_g.cpu().numpy(), a_c.numpy(), atol=ATOL)
    np.testing.assert_array_equal(info_g["tile_overflow"].cpu().numpy(),
                                  info_c["tile_overflow"].numpy())


def test_wrapper_rejects_bad_inputs(dev):
    ent = torch.zeros((1, 4, 8, 9), device=dev)
    counts = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        comp.composite_tiles_cuda(ent.double(), counts, 32, 32, 16, 2, 2)
    with pytest.raises(ValueError):
        comp.composite_tiles_cuda(ent, counts.long(), 32, 32, 16, 2, 2)
    with pytest.raises(ValueError):
        comp.composite_tiles_cuda(ent, counts, 64, 32, 16, 2, 2)
    rgb = torch.zeros((1, 32, 32, 3), device=dev)
    tfin = torch.ones((4, 256), device=dev)
    done = torch.ones((4,), dtype=torch.int32, device=dev)
    g_rgb = torch.zeros((1, 32, 32, 3), device=dev)
    g_a = torch.zeros((1, 32, 32), device=dev)
    bwd = comp.composite_tiles_bwd_cuda
    with pytest.raises(ValueError):
        bwd(ent, counts, rgb, tfin, done.long(), g_rgb, g_a, 32, 32, 16, 2,
            2)
    with pytest.raises(ValueError):
        bwd(ent, counts, rgb, tfin[:, :64], done, g_rgb, g_a, 32, 32, 16, 2,
            2)
    with pytest.raises(ValueError):
        bwd(ent, counts, rgb, tfin, done, g_rgb[..., :2], g_a, 32, 32, 16, 2,
            2)
    with pytest.raises(ValueError):
        bwd(ent, counts, rgb[:, :16], tfin, done, g_rgb, g_a, 32, 32, 16, 2,
            2)
    with pytest.raises(ValueError):
        bwd(ent, counts, rgb, tfin, done, g_rgb, g_a.cpu(), 32, 32, 16, 2, 2)
    packed = torch.zeros((10, 9), device=dev)
    gidx = torch.zeros((1, 4, 8), dtype=torch.int32, device=dev)
    valid = torch.ones((1, 4, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        gat.gather_entries_cuda(packed.double(), gidx, valid)
    with pytest.raises(ValueError):
        gat.gather_entries_cuda(packed, gidx.long(), valid)
    with pytest.raises(ValueError):
        gat.gather_entries_cuda(packed, gidx, valid[..., :4])
    with pytest.raises(ValueError):
        gat.gather_entries_cuda(packed[:, :8], gidx, valid)


def test_scene_defaults_to_cuda(dev):
    """A tiny scene with no device argument runs on the card end to end
    and renders through the kernel."""
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(-1, 1, size=(3, 64, 64)).astype(np.float32)
            for _ in range(3)]
    model = stt.Mast3rModel.init_random(stt.ModelConfig.tiny())
    assert next(model.net.parameters()).is_cuda
    cfg = stt.default_config()
    import dataclasses
    cfg = dataclasses.replace(cfg, ga=dataclasses.replace(cfg.ga, niter1=15,
                                                          niter2=8))
    scene = stt.Scene(config=cfg)
    assert scene.device.type == "cuda"
    scene.add_images(model, imgs[:2])
    scene.add_images(model, imgs[2:])
    scene.init_3dgs()
    assert scene.gs_state.params["means"].is_cuda
    before = comp.composite_packed_cuda.launches
    rgb, alpha, _ = scene.render_3dgs_original(64, 64)
    assert comp.composite_packed_cuda.launches == before + 1
    assert rgb.shape == (3, 64, 64, 3) and bool(torch.isfinite(rgb).all())


def test_rect_slice_on_cuda_matches_cpu(dev, tmp_path):
    """tests/test_torch_rect.py's slice at (H, W) = (64, 96) on the card
    against the same calls on the CPU, stage by stage, each stage on the
    same inputs: the tiny model from seed 0 (its weights copied to the
    card), three smooth images of seed 7, the GA at 15 + 8, `add_images`
    2 + 1 and `init_3dgs`. The CPU route is held to the JAX package by
    tests/test_torch_rect.py, which closes the chain.

      - the network's outputs on the slice's first pair within 2e-5 of
        each output's largest magnitude (the rect test's REL_TOL);
      - each `add_images` call's condensed data: the correspondences, the
        pairs and their flags, the image sizes, principal points and base
        focals equal, the MST equal; the match confidences within 2e-5 of
        their largest (the network's bound, as they are its outputs); the
        core depths, each camera's anchor depths over their median, within
        4e-5 x (1 + |core depth|) of the camera's largest: the network's
        bound on the raw depths, and the same bound again through the
        median they are divided by;
      - the GA of each call on the CPU call's recorded inputs (data, MST,
        warm start) on the card: poses within 1e-3 in camera 0's frame,
        intrinsics within 1e-3 relative (tests/test_torch_slice.py's);
      - the CPU scene's splats rendered on the card (K1 launched once)
        within `close_renders`' bounds of the CPU's render;
      - the card's own scene: principal points nearer (W / 2, H / 2) than
        the swap, finite renders of (3, H, W).

    The two end-to-end scenes are not held to each other: float32 noise
    in the network's far points (the depth ratio to an anchor divides by
    depths near 0) moves the condensed core depths, and the GA turns that
    into far more than 1e-3 between the two devices' second calls on this
    scene, as it does between any two float32 programs."""
    import dataclasses
    import starst3r_tpu_torch.reconstruct as reconstruct_mod
    from starst3r_tpu_torch.alignment import ga
    from torch_slice_inputs import (close_renders, recorded_calls,
                                    smooth_images)
    rel_tol = 2e-5
    h, w = 64, 96
    imgs = smooth_images(3, h=h, w=w)
    cpu_model = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(), seed=0,
                                            device="cpu")
    card_model = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(),
                                             seed=0, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    pair = [torch.from_numpy(np.ascontiguousarray(
        im.transpose(1, 2, 0)[None])) for im in imgs[:2]]
    want = cpu_model.infer_pair_batch(*pair)
    got = card_model.infer_pair_batch(*(x.to(dev) for x in pair))
    for key, val in want.items():
        scale = float(val.abs().max())
        assert (float((got[key].cpu() - val).abs().max())
                <= rel_tol * scale), key

    cfg = stt.default_config()
    cfg = dataclasses.replace(cfg, ga=dataclasses.replace(cfg.ga, niter1=15,
                                                          niter2=8))
    calls, scenes = {}, {}
    for name, d, model in (("cpu", "cpu", cpu_model),
                           ("cuda", dev, card_model)):
        with recorded_calls(reconstruct_mod) as calls[name]:
            scene = stt.Scene(cache_dir=str(tmp_path / name), config=cfg,
                              device=d)
            scene.add_images(model, imgs[:2])
            scene.add_images(model, imgs[2:])
            scene.init_3dgs()
        scenes[name] = scene
    cpu, card = scenes["cpu"], scenes["cuda"]
    assert card.gs_state.params["means"].is_cuda

    def in_cam0(c2w):
        c2w = np.asarray(torch.as_tensor(c2w).cpu(), np.float64)
        return np.linalg.inv(c2w[0])[None] @ c2w

    for (args_c, kw_c, _), (args_g, _, _) in zip(calls["cpu"],
                                                  calls["cuda"]):
        (data_c, mst_c, ga_cfg), (data_g, mst_g) = args_c[:3], args_g[:2]
        assert mst_g == mst_c
        for field in ("corr_img1", "corr_idx1", "corr_img2", "corr_idx2",
                      "corr_pair", "pair_img1", "pair_img2",
                      "pair_matching_ok", "corr_pix1", "corr_pix2",
                      "imsizes", "pps", "base_focals", "core_pix"):
            np.testing.assert_array_equal(getattr(data_g, field),
                                          getattr(data_c, field),
                                          err_msg=field)
        conf_c = data_c.corr_conf
        assert (np.abs(data_g.corr_conf - conf_c).max()
                <= rel_tol * np.abs(conf_c).max())
        core_c, core_g = data_c.core_depth, data_g.core_depth
        bound = (2 * rel_tol * np.abs(core_c).max(axis=1, keepdims=True)
                 * (1 + np.abs(core_c)))
        ratio = np.abs(core_g - core_c) / bound
        assert ratio.max() <= 1.0, (ratio.max(), np.abs(core_c).max())
        prev = kw_c["prev_params"]
        want_ga, _ = ga.run_global_alignment(data_c, mst_c, ga_cfg,
                                             prev_params=prev, device="cpu")
        got_ga, _ = ga.run_global_alignment(
            data_c, mst_c, ga_cfg, device=dev, prev_params=None
            if prev is None else ga.GAParams(*[p.to(dev) for p in prev]))
        np.testing.assert_allclose(in_cam0(got_ga.cam2w),
                                   in_cam0(want_ga.cam2w), atol=1e-3)
        np.testing.assert_allclose(got_ga.K.cpu().numpy(),
                                   want_ga.K.numpy(), rtol=1e-3)

    params = cpu.gs_state.params
    want_rgb, want_alpha, _ = stt.gs.render(
        params, cpu.w2c, cpu.intrinsics, w, h, cfg.splat,
        n_alive=cpu.gs_state.n_alive)
    before = comp.composite_packed_cuda.launches
    rgb, alpha, _ = stt.gs.render(
        {k: v.to(dev) for k, v in params.items()}, cpu.w2c, cpu.intrinsics,
        w, h, cfg.splat, n_alive=cpu.gs_state.n_alive)
    torch.cuda.synchronize()
    assert comp.composite_packed_cuda.launches == before + 1
    assert rgb.shape == (3, h, w, 3) and rgb.is_cuda
    close_renders(rgb.cpu().numpy(), want_rgb.numpy())
    close_renders(alpha.cpu().numpy(), want_alpha.numpy())
    pp = card.intrinsics[:, :2, 2]
    assert (np.linalg.norm(pp - [w / 2, h / 2], axis=-1)
            < np.linalg.norm(pp - [h / 2, w / 2], axis=-1)).all(), pp
    rgb_own, _, _ = card.render_3dgs_original(w, h)
    assert rgb_own.shape == (3, h, w, 3)
    assert bool(torch.isfinite(rgb_own).all())


def _rotz(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]], np.float32)


def _planted_ba(rng, c, npts, window, f=100.0, rot=0.03, tr=0.08):
    """Cameras on a path observing shared world points, each camera's
    exact pixels and depths in its own section of the core grid (zero
    residual at the planted poses), correspondences between cameras up to
    ``window`` apart, and a perturbed start with camera 0 kept."""
    pps = np.full((c, 2), 64.0, np.float32)
    cam2w = np.tile(np.eye(4, dtype=np.float32)[None], (c, 1, 1))
    for i in range(c):
        cam2w[i, :3, :3] = _rotz(0.03 * i)
        cam2w[i, :3, 3] = [0.15 * i, 0.03 * i, -0.05 * i]
    world = rng.uniform(-1.5, 1.5, size=(npts, 3)).astype(np.float32)
    world[:, 2] += 6.0
    s = c * npts
    core_pix = np.zeros((s, 2), np.float32)
    depths = np.ones((c, s), np.float32)
    for i in range(c):
        w2c = np.linalg.inv(cam2w[i])
        p = world @ w2c[:3, :3].T + w2c[:3, 3]
        sl = slice(i * npts, (i + 1) * npts)
        core_pix[sl] = p[:, :2] / p[:, 2:3] * f + pps[i]
        depths[i, sl] = p[:, 2]
    img1, idx1, img2, idx2 = [], [], [], []
    for i in range(c):
        for j in range(i + 1, min(c, i + window + 1)):
            img1 += [i] * npts
            idx1 += list(range(i * npts, (i + 1) * npts))
            img2 += [j] * npts
            idx2 += list(range(j * npts, (j + 1) * npts))
    noisy = cam2w.copy()
    for i in range(1, c):
        noisy[i, :3, :3] = _rotz(rng.normal() * rot) @ noisy[i, :3, :3]
        noisy[i, :3, 3] += rng.normal(size=3) * tr
    i32 = lambda x: np.array(x, np.int32)
    return dict(cam2w=cam2w, noisy=noisy, focals=np.full(c, f, np.float32),
                pps=pps, depths=depths, core_pix=core_pix, img1=i32(img1),
                idx1=i32(idx1), img2=i32(img2), idx2=i32(idx2),
                conf=np.ones(len(img1), np.float32))


def _to(dv, *arrays):
    """numpy arrays as tensors on ``dv``: integers as int64, floats as
    float32."""
    return tuple(torch.as_tensor(np.asarray(
        a, np.int64 if np.asarray(a).dtype.kind in "iu" else np.float32),
        device=dv) for a in arrays)


def _thetas(cam2w, focals):
    """The polish's packed (C, 8) parameters, as the refiners build them."""
    from starst3r_tpu_torch.utils.se3 import rotmat_to_quat
    c2w = torch.as_tensor(cam2w)
    return torch.cat([rotmat_to_quat(c2w[:, :3, :3]), c2w[:, :3, 3],
                      torch.log(torch.as_tensor(focals))[:, None]], dim=1)


def _assert_system(dev, fn, thetas, data):
    """A normal-equation builder on the card against the CPU at one point:
    the matrix and the gradient within 1e-5 of their largest entries (the
    same products, summed in another order), the cost to 1e-5
    relative."""
    want = fn(thetas, *_to("cpu", *data))
    got = fn(thetas.to(dev), *_to(dev, *data))
    for g, w in zip(got[:2], want[:2]):
        assert g.is_cuda
        scale = float(w.abs().max())
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * scale
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)


@pytest.mark.parametrize("opt_focal", [False, True])
def test_lm_refine_on_cuda_matches_cpu(dev, opt_focal):
    from starst3r_tpu_torch.alignment import lm
    d = _planted_ba(np.random.default_rng(0), c=6, npts=40, window=5)
    _assert_system(dev, lm._normal_eqs, _thetas(d["noisy"], d["focals"]),
                   [d[k] for k in ("img1", "idx1", "img2", "idx2", "conf",
                                   "core_pix", "pps", "depths")])
    args = (d["noisy"], d["focals"], d["pps"], d["depths"], d["core_pix"],
            d["img1"], d["idx1"], d["img2"], d["idx2"], d["conf"])
    (co, cf, cc), (go, gf, gc) = (
        lm.lm_refine(*args, iters=12, opt_focal=opt_focal, device=dv)
        for dv in ("cpu", dev))
    assert len(gc) == 12 and gc[-1] < 1e-4 * gc[0]
    assert all(b <= a for a, b in zip(gc, gc[1:]))
    np.testing.assert_allclose(go, co, atol=1e-3)
    np.testing.assert_allclose(gf, cf, rtol=1e-3)
    assert np.abs(go[:, :3, 3] - d["cam2w"][:, :3, 3]).max() < 1e-2
    assert np.abs(go[:, :3, :3] - d["cam2w"][:, :3, :3]).max() < 1e-2


def test_schur_refine_on_cuda_matches_cpu(dev):
    from starst3r_tpu_torch.alignment import schur
    d = _planted_ba(np.random.default_rng(1), c=30, npts=16, window=3,
                    rot=0.02, tr=0.05)
    tracks = schur.build_tracks(d["img1"], d["idx1"], d["img2"], d["idx2"],
                                d["conf"], 30, d["core_pix"].shape[0],
                                max_obs=8)
    _assert_system(dev, schur._reduced_system,
                   _thetas(d["noisy"], d["focals"]),
                   [tracks.cam, tracks.pt, tracks.w, d["core_pix"],
                    d["pps"], d["depths"]])
    args = (d["noisy"], d["focals"], d["pps"], d["depths"], d["core_pix"],
            tracks)
    (co, cf, cc), (go, gf, gc) = (
        schur.schur_refine(*args, iters=15, opt_focal=False, device=dv)
        for dv in ("cpu", dev))
    assert len(gc) == 15 and gc[-1] < 1e-4 * gc[0]
    assert all(b <= a for a, b in zip(gc, gc[1:]))
    np.testing.assert_allclose(go, co, atol=1e-3)
    t_err = np.linalg.norm(go[:, :3, 3] - d["cam2w"][:, :3, 3], axis=1)
    assert t_err.max() < 2e-2


def test_lora_ga_on_cuda_matches_cpu(dev):
    """The GA with spectral low-rank depth (the basis expansion in full
    float32 on the card) against the same GA on the CPU."""
    from starst3r_tpu_torch.alignment.ga import run_global_alignment
    from starst3r_tpu_torch.alignment.spectral import (
        spectral_projection_of_depthmaps)
    from starst3r_tpu_torch.utils.synthetic import synthetic_ga_scene
    # cameras on an arc facing a sphere, correspondences snapped to the
    # 8 x 8 core grid of a 64 px image
    data, mst, _, _ = synthetic_ga_scene(n_cams=4, hw=64, focal=90.0,
                                         subsample=8)
    grid = (8, 8)
    rng = np.random.default_rng(2)
    colors = rng.uniform(size=(4, grid[0] * grid[1], 3)).astype(np.float32)
    coeffs, basis = spectral_projection_of_depthmaps(
        colors, data.core_depth, grid, k=16)
    cfg = stt.GAConfig(niter1=15, niter2=8, opt_depth=True, lora_depth=True,
                       lora_k=16)
    res = {}
    for dv in ("cpu", dev):
        r, par = run_global_alignment(data, mst, cfg, depth_basis=basis,
                                      depth_coeffs=coeffs, device=dv)
        assert par.core_depth.shape == (4, 16)
        assert r.depth.device.type == torch.device(dv).type
        res[str(dv)] = r
    c, g = res["cpu"], res[str(dev)]
    rel = lambda m: np.linalg.inv(m[0].astype(np.float64))[None] @ m
    np.testing.assert_allclose(rel(g.cam2w.cpu().numpy()),
                               rel(c.cam2w.numpy()), atol=1e-4)
    np.testing.assert_allclose(g.K.cpu().numpy(), c.K.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(g.depth.cpu().numpy(), c.depth.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(g.loss_coarse, c.loss_coarse, rtol=1e-4)
    np.testing.assert_allclose(g.loss_fine, c.loss_fine, rtol=1e-4)


ROWS_TOL = 1e-5


def _rows_inputs(name, dev):
    """One of tests/torch_ga_scene.py's gather cases on the card, with its
    CSR."""
    from torch_ga_scene import gather_case
    r, idx, ct = gather_case(name)
    idx = torch.from_numpy(idx).to(dev)
    return r, idx, torch.from_numpy(ct).to(dev), row_sum._gather_csr(idx, r)


def _check_rows(got, idx, ct, csr, r):
    """The kernel's output against its plain version summed in float64
    (on the card ``index_add_`` in float32 adds with atomics, which on a
    row of 368,640 entries sits ~0.04 from the exact sum, beyond 1e-5 (1 +
    max)), and bit for bit against `_gather_rows_bwd_in_order`, its own
    summation order in PyTorch; empty rows exactly 0."""
    want = row_sum._gather_rows_bwd_plain(idx, ct.double(), r)
    assert got.shape == want.shape == (r, ct.shape[1])
    assert float((got.double() - want).abs().max()) <= ROWS_TOL * (
        1 + float(want.abs().max()))
    assert torch.equal(got, row_sum._gather_rows_bwd_in_order(ct, *csr))
    empty = torch.bincount(idx, minlength=r) == 0
    assert bool((got[empty] == 0).all())


@pytest.mark.parametrize("name", ["depth", "K", "cam2w", "proj",
                                  "pair_cam2w", "pair_pts3d", "empty_rows",
                                  "one_row", "long_row", "split_short_row"])
def test_gather_rows_bwd_matches_plain(dev, name):
    r, idx, ct, csr = _rows_inputs(name, dev)
    before = row_sum.gather_rows_bwd_cuda.launches
    got = row_sum.gather_rows_bwd_cuda(ct, *csr)
    torch.cuda.synchronize()
    assert row_sum.gather_rows_bwd_cuda.launches == before + 1
    _check_rows(got, idx, ct, csr, r)
    if name in ("long_row", "split_short_row"):
        assert row_sum._gather_plan(ct.shape[0], r, ct.shape[1]).cluster > 1


@pytest.mark.parametrize("name", ["depth", "cam2w", "pair_pts3d",
                                  "long_row"])
def test_gather_rows_bwd_is_deterministic(dev, name):
    _, _, ct, csr = _rows_inputs(name, dev)
    a = row_sum.gather_rows_bwd_cuda(ct, *csr)
    b = row_sum.gather_rows_bwd_cuda(ct, *csr)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["depth", "K", "pair_pts3d", "long_row",
                                  "split_short_row"])
def test_gather_rows_bwd_in_a_cuda_graph(dev, name):
    _, _, ct, csr = _rows_inputs(name, dev)
    eager = row_sum.gather_rows_bwd_cuda(ct, *csr)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = row_sum.gather_rows_bwd_cuda(ct, *csr)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_gather_rows_bwd_no_entries(dev):
    idx = torch.zeros(0, dtype=torch.int64, device=dev)
    csr = row_sum._gather_csr(idx, 5)
    got = row_sum.gather_rows_bwd_cuda(torch.zeros((0, 7), device=dev), *csr)
    torch.cuda.synchronize()
    assert got.shape == (5, 7) and bool((got == 0).all())


@pytest.mark.parametrize("m", [3000, 200_000])
@pytest.mark.parametrize("d", [3, 33, 45, 100])
def test_gather_rows_bwd_width_not_a_multiple_of_32(dev, d, m):
    """Odd widths, in rows short enough for one block and long enough for
    a cluster of blocks; the last two rows empty."""
    rng = np.random.default_rng(d)
    r = 11
    idx = torch.from_numpy(rng.integers(0, r - 2, m)).to(dev)
    ct = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(dev)
    csr = row_sum._gather_csr(idx, r)
    got = row_sum.gather_rows_bwd_cuda(ct, *csr)
    torch.cuda.synchronize()
    _check_rows(got, idx, ct, csr, r)
    assert bool((got[r - 2:] == 0).all())


def test_gather_rows_bwd_misaligned_cotangent(dev):
    """A cotangent that does not start on 16 bytes (the kernel reads
    float4s where D is a multiple of 4) is copied first: the same bits."""
    r, idx, ct, csr = _rows_inputs("cam2w", dev)
    buf = torch.empty(ct.numel() + 1, device=dev)
    shifted = buf[1:].view(ct.shape)
    shifted.copy_(ct)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    got = row_sum.gather_rows_bwd_cuda(shifted, *csr)
    torch.cuda.synchronize()
    assert torch.equal(got, row_sum.gather_rows_bwd_cuda(ct, *csr))


def _eager_phase(params, state, niter, lr_base, lr_end, gamma, phase, cfg):
    """The graph route's plain version: the same step, run eagerly."""
    from starst3r_tpu_torch.alignment import ga
    ph = ga._Phase(params, state, niter, lr_base, lr_end, gamma, phase, cfg)
    ph.steps(niter)
    return ga.GAParams(*[p.detach() for p in ph.params]), float(ph.last_loss)


def _scaled(got, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def test_ga_graph_route_matches_eager_steps_on_cuda(dev, monkeypatch):
    """On the card each GA phase captures its step once and replays it,
    with one host read per ``jit_chunk`` steps. Against the same step run
    eagerly on the card (the scene of tests/test_torch_ga.py, 15 + 8
    steps; the step's three launches, `ga_step.ga_step_cuda`): poses in
    the root camera's frame, K and depth, each scaled by its largest
    magnitude, within twice the distance of two eager runs from each
    other, and never held tighter than 1e-6. The step counter ends at
    ``niter``: the warm-up steps before the capture did not leak into the
    phase."""
    from torch_ga_scene import ga_scene
    from starst3r_tpu_torch.alignment import ga
    data, mst = ga_scene(4)
    cfg = stt.GAConfig(niter1=15, niter2=8, jit_chunk=7)
    phases = []

    class Recorded(ga._Phase):
        def __init__(self, *args):
            super().__init__(*args)
            phases.append(self)

    monkeypatch.setattr(ga, "_Phase", Recorded)
    counters = ("captures", "replays", "host_reads")
    for name in counters:
        monkeypatch.setattr(ga._optimize_phase, name, 0)
    graph, params = ga.run_global_alignment(data, mst, cfg, device=dev)
    assert {n: getattr(ga._optimize_phase, n) for n in counters} == {
        "captures": 2, "replays": 15 + 8, "host_reads": 3 + 2}
    assert [int(p.count) for p in phases] == [15, 8]
    assert all(p.is_cuda for p in params)

    monkeypatch.setattr(ga, "_optimize_phase", _eager_phase)
    eager = [ga.run_global_alignment(data, mst, cfg, device=dev)[0]
             for _ in range(2)]
    _check_graph_against_eager(graph, eager, mst[0])


def _check_graph_against_eager(graph, eager, root):
    """The graph route's GA result against two eager runs': poses in the
    root camera's frame, K, depth and the phase losses, each scaled by its
    largest magnitude, within twice the eager runs' distance from each
    other, never held tighter than 1e-6."""
    def errors(a, b):
        rel = lambda m: (np.linalg.inv(m[root].astype(np.float64))[None]
                         @ m.astype(np.float64))
        return {"cam2w": _scaled(rel(a.cam2w.cpu().numpy()),
                                 rel(b.cam2w.cpu().numpy())),
                "K": _scaled(a.K.cpu().numpy(), b.K.cpu().numpy()),
                "depth": _scaled(a.depth.cpu().numpy(),
                                 b.depth.cpu().numpy()),
                "loss": max(abs(a.loss_coarse - b.loss_coarse)
                            / abs(b.loss_coarse),
                            abs(a.loss_fine - b.loss_fine)
                            / abs(b.loss_fine))}

    spread = errors(eager[1], eager[0])
    got = errors(graph, eager[0])
    for name, err in got.items():
        assert err <= max(2 * spread[name], 1e-6), (name, err, spread)


def test_ga_512px_scale_on_cuda(dev, monkeypatch):
    from starst3r_tpu_torch.alignment.ga_loss import ga_loss_cuda
    """The JAX package's 512 px GA operating point
    (tests/test_ga_groundtruth.py::test_ga_512px_scale_memory: 10 cameras,
    S = 4,096 core points, 368,640 anchored correspondences, GA 50 + 20 at
    jit_chunk 10) on the card: finite poses, the fused loss launched once
    in each of each phase's warm-up steps and its capture, and the graph
    route against the eager steps as above."""
    from starst3r_tpu_torch.alignment import ga
    from starst3r_tpu_torch.utils.synthetic import synthetic_ga_scene
    data, mst, _, _ = synthetic_ga_scene(
        n_cams=10, hw=512, focal=720.0, subsample=8, anchored=True,
        orbit=True, sph_r=1.2, spread=0.2)
    cfg = stt.GAConfig(niter1=50, niter2=20, jit_chunk=10)
    m = len(data.corr_idx1)
    assert m == 368_640
    before = ga_loss_cuda.launches
    graph, _ = ga.run_global_alignment(data, mst, cfg, device=dev)
    assert ga_loss_cuda.launches - before == (ga._WARMUP_STEPS + 1) * 2
    assert np.isfinite(graph.cam2w.cpu().numpy()).all()
    monkeypatch.setattr(ga, "_optimize_phase", _eager_phase)
    eager = [ga.run_global_alignment(data, mst, cfg, device=dev)[0]
             for _ in range(2)]
    _check_graph_against_eager(graph, eager, mst[0])


LOSS_CASES = ("ga_scene", "512px", "224x160", "512x384")
# the fused loss against its order in PyTorch on the card (the same
# arithmetic in the same order; the kernel's powf and PyTorch's pow may
# differ in the last bit), and against the autograd chain on the card: the
# loss to 1e-6 relative, each gradient within 1e-4 of its largest magnitude
# (an element of the depth gradient sums a few correspondences, each
# carrying its forward's float32 rounding through the cancellation in
# dz = gq_z + a gq_x + b gq_y: the two float32 routes part by 1.2e-5 on six
# 224 x 160 views in phase 2), and no farther from a float64 evaluation of
# the chain than twice the float32 chain on the card (never held below
# 1e-6)
LOSS_RTOL = 1e-6
LOSS_IN_ORDER_TOL = 1e-6
LOSS_GRAD_TOL = 1e-4
LOSS_F64_FLOOR = 1e-6


def _loss_case(name, dev):
    """(state, cfg, [K, w2c, cam2w, depth], (data, mst)) at a perturbed
    start of one of
    the fused loss's shapes: tests/test_torch_ga.py's scene (4 cameras), the
    JAX package's 512 px operating point (10 cameras, 368,640
    correspondences; two pairs below the matching threshold), and six views
    at the benchmark's recon shapes (`torch_ga_scene.condensed_case`)."""
    from torch_ga_scene import condensed_case, ga_scene
    from starst3r_tpu_torch.alignment import ga
    from starst3r_tpu_torch.utils.synthetic import synthetic_ga_scene
    if name == "ga_scene":
        data, mst = ga_scene(4)
    elif name == "512px":
        data, mst, _, _ = synthetic_ga_scene(
            n_cams=10, hw=512, focal=720.0, subsample=8, anchored=True,
            orbit=True, sph_r=1.2, spread=0.2)
        ok = np.ones_like(data.pair_matching_ok)
        ok[[3, 40]] = False
        data = data._replace(pair_matching_ok=ok)
    else:
        w, h = map(int, name.split("x"))
        data, mst = condensed_case(h, w)
    cfg = stt.GAConfig()
    state = ga.make_state(data, mst, cfg, device=dev)
    g = torch.Generator().manual_seed(0)
    params = ga.GAParams(*[
        p + 0.05 * torch.randn(p.shape, generator=g).to(dev)
        for p in ga.init_params(data, device=dev)])
    return state, cfg, [t.detach() for t in ga.make_K_cam_depth(
        params, state)], (data, mst)


def _loss_data(state, cfg, phase):
    from starst3r_tpu_torch.alignment import ga_loss as gl
    return gl.make_loss_data(state, phase,
                             cfg.gamma1 if phase == 1 else cfg.gamma2,
                             cfg.gamma_d, cfg.loss_dust3r_w)


def _loss_inputs(tensors, phase, dev, alpha=0.7):
    K, w2c, cam2w, depth = tensors
    return (K, cam2w, depth, K @ w2c[:, :3] if phase == 2 else None,
            torch.tensor(alpha, device=dev))


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", LOSS_CASES)
def test_ga_loss_matches_the_plain_chain_on_cuda(dev, case, phase):
    """The fused loss's kernel: its loss and its four gradients (K, cam2w,
    depth, proj in phase 2) against `ga_loss_in_order` on the card, and
    against autograd of the losses' plain chain on the card with respect to
    the same tensors."""
    from starst3r_tpu_torch.alignment import ga
    from starst3r_tpu_torch.alignment import ga_loss as gl
    state, cfg, tensors, (scene, mst) = _loss_case(case, dev)
    data = _loss_data(state, cfg, phase)
    inputs = _loss_inputs(tensors, phase, dev)
    before = gl.ga_loss_cuda.launches
    loss, grads = gl.ga_loss_cuda(*inputs, data)
    torch.cuda.synchronize()
    assert gl.ga_loss_cuda.launches == before + 1
    got = gl._views(grads, gl._grad_layout(*data.dims[:2], phase))
    want_loss, want = gl.ga_loss_in_order(*inputs, data)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    for name, w in gl._views(want, gl._grad_layout(*data.dims[:2],
                                                     phase)).items():
        if w.numel():
            assert bool(torch.isfinite(got[name]).all()), name
            assert _scaled(got[name].cpu(), w.cpu()) <= \
                LOSS_IN_ORDER_TOL, name

    def chain(tensors, state, alpha):
        """The chain's loss and its gradients with respect to tensors."""
        leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
        if phase == 1:
            main = ga._loss_3d(*leaves, state, data.gamma, alpha)
        else:
            main = ga._loss_2d(*leaves, state, data.gamma, alpha)
        out = main + cfg.loss_dust3r_w * ga._loss_dust3r(
            ga._core_pts3d(*leaves[:3], state), leaves[1], state,
            cfg.gamma_d)
        return float(out.detach()), torch.autograd.grad(out, leaves)

    names = ("K", "cam2w", "depth", "proj")[:3 + (phase == 2)]
    tensors = [t for t in inputs[:4] if t is not None]
    plain_loss, plain = chain(tensors, state, inputs[-1])
    assert abs(float(loss) - plain_loss) <= LOSS_RTOL * abs(plain_loss)
    state64 = ga.make_state(scene, mst, cfg, device="cpu")
    state64 = state64._replace(**{
        k: v.double() for k, v in state64._asdict().items()
        if isinstance(v, torch.Tensor) and v.is_floating_point()})
    _, ref = chain([t.cpu().double() for t in tensors], state64,
                   inputs[-1].cpu().double())
    for name, w, r in zip(names, plain, ref):
        g = got[name].cpu()
        assert _scaled(g, w.cpu()) <= LOSS_GRAD_TOL, name
        assert _scaled(g, r) <= max(2 * _scaled(w.cpu(), r),
                                    LOSS_F64_FLOOR), name


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", ["ga_scene", "512px"])
def test_ga_loss_is_deterministic_and_graph_safe_on_cuda(dev, case, phase):
    """Two launches on the same inputs, and a launch captured in a CUDA
    graph and replayed, give the eager launch's loss and gradient bit for
    bit (no atomics; a fixed summation order)."""
    from starst3r_tpu_torch.alignment import ga_loss as gl
    state, cfg, tensors, _ = _loss_case(case, dev)
    data = _loss_data(state, cfg, phase)
    inputs = _loss_inputs(tensors, phase, dev)
    a = gl.ga_loss_cuda(*inputs, data)
    b = gl.ga_loss_cuda(*inputs, data)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = gl.ga_loss_cuda(*inputs, data)
    out[0].zero_()
    out[1].zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], a[0]) and torch.equal(out[1], a[1])


def test_ga_loss_launches_per_step_on_cuda(dev):
    """A GA step on the card calls the fused loss and the step's kernels
    (`ga_step.ga_step_cuda`) once each; a capture counts its three warm-up
    steps and the captured step, its replays nothing."""
    from torch_ga_scene import ga_scene
    from starst3r_tpu_torch.alignment import ga
    from starst3r_tpu_torch.alignment import ga_loss as gl
    from starst3r_tpu_torch.alignment import ga_step as gs
    data, mst = ga_scene(4)
    cfg = stt.GAConfig()
    state = ga.make_state(data, mst, cfg, device=dev)
    counts = lambda: (gl.ga_loss_cuda.launches, gs.ga_step_cuda.launches)
    for phase in (1, 2):
        ph = ga._Phase(ga.init_params(data, device=dev), state, 20, 0.07,
                       0.0, 1.1, phase, cfg)
        before = counts()
        ph.step()
        assert counts() == (before[0] + 1, before[1] + 1)
        graph = ga._capture(ph)
        seen = 1 + ga._WARMUP_STEPS + 1
        after = (before[0] + seen, before[1] + seen)
        assert counts() == after
        graph.replay()
        torch.cuda.synchronize()
        assert counts() == after and int(ph.count) == 2


# the step's kernels (`csrc/ga_step.cu`) against their order in PyTorch on
# the card (`ga_step.reparam_in_order`, `update_in_order`, fed the same
# fused loss's output): the same arithmetic, where libdevice's expf, cosf,
# powf and rsqrtf, compiled with -fmad=false, may round the last bit
# otherwise than PyTorch's kernels of them, so within 1e-6 of each
# output's largest magnitude (the params' update from a mid-run state)
STEP_IN_ORDER_TOL = 1e-6
STEP_SHAPES = ("ga_scene", "224x160", "512x384")


def _step_scene(shape):
    from torch_ga_scene import condensed_case, ga_scene
    if shape == "ga_scene":
        return ga_scene(4)
    w, h = map(int, shape.split("x"))
    return condensed_case(h, w)


def _step_kernels_against_in_order(ph, data, mid):
    """Launch `ga_reparam` and `ga_update` on a copy of the phase's state
    and run their PyTorch order on another: {name: scaled difference},
    and whether every output is equal bit for bit."""
    from starst3r_tpu_torch.alignment import ga_step as gs
    from starst3r_tpu_torch.alignment.ga_loss import ga_loss_cuda
    old = [t.detach().clone() for t in ph.tensors()]
    got = [t.clone() for t in old]
    buf = gs.step_buffer(data)
    gs.ga_reparam_cuda(got[:6], got[18], buf, data)
    loss, grads = ga_loss_cuda(*gs.loss_inputs(buf, data), ph.loss_data)
    fwd = {k: v.clone() for k, v in gs.fwd_views(buf, data).items()}
    gs.ga_update_cuda(got, loss, grads, buf, data)
    torch.cuda.synchronize()
    want_fwd = gs.reparam_in_order(old[:6], old[18], data)
    want = gs.update_in_order(old, loss, grads, fwd, data)
    errs, equal = {}, True
    for name, w in want_fwd.items():
        errs[name] = _scaled(fwd[name].cpu(), w.cpu())
        equal &= bool(torch.equal(fwd[name], w))
    for i, (g, w) in enumerate(zip(got, want)):
        if i < 6 and not mid:
            continue   # step 1: +-lr by a gradient's sign (the root's gauge)
        if i < 6:
            g, w = g - old[i], w - old[i]
        errs[i] = _scaled(g.cpu(), w.cpu()) if g.is_floating_point() \
            else float(not torch.equal(g, w))
        equal &= bool(torch.equal(g, w))
    return errs, equal


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", ["default", "frozen", "shared", "exp_depth",
                                  "mul", "lora", "lora_exp", "opt_pp_off"])
def test_ga_step_kernels_match_in_order_on_cuda(dev, case, phase):
    """The step's two kernels against their order in PyTorch on the card,
    on tests/test_torch_ga_step.py's cases, from the GA's start (step 1,
    all log-sizes tied; the outputs, the moments) and from a mid-run
    state (every output, the params' update too)."""
    from torch_ga_scene import mid_run, step_phase
    for perturb, mid in ((False, False), (True, True)):
        ph, data, _ = step_phase(case, phase, device=dev, perturb=perturb)
        if mid:
            mid_run(ph)
        errs, _ = _step_kernels_against_in_order(ph, data, mid)
        for name, err in errs.items():
            assert err <= STEP_IN_ORDER_TOL, (name, err)


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("shape", STEP_SHAPES[1:])
def test_ga_step_kernels_at_the_recon_shapes_on_cuda(dev, shape, phase):
    """As above at the recon cells' condensed shapes (six views of
    224 x 160 and 512 x 384: several depth blocks a camera, a stage-A
    loop of several turns a thread)."""
    from torch_ga_scene import mid_run, step_phase
    ph, data, _ = step_phase("default", phase, device=dev,
                          scene=_step_scene(shape))
    mid_run(ph)
    errs, _ = _step_kernels_against_in_order(ph, data, True)
    for name, err in errs.items():
        assert err <= STEP_IN_ORDER_TOL, (name, err)


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", ["default", "lora"])
def test_ga_step_is_deterministic_and_graph_safe_on_cuda(dev, case, phase):
    """Two steps from the same state, and a step captured in a CUDA graph
    and replayed from that state, give the same state bit for bit (no
    atomics; a fixed summation order)."""
    from torch_ga_scene import mid_run, step_phase
    from starst3r_tpu_torch.alignment import ga_step as gs
    ph, data, _ = step_phase(case, phase, device=dev)
    mid_run(ph)
    start = [t.detach().clone() for t in ph.tensors()]
    state = [t.detach() for t in ph.tensors()]

    def restore():
        for t, s in zip(state, start):
            t.copy_(s)

    runs = []
    for _ in range(2):
        restore()
        gs.ga_step_cuda(state, ph.buf, data, ph.loss_data)
        torch.cuda.synchronize()
        runs.append([t.clone() for t in state])
    restore()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gs.ga_step_cuda(state, ph.buf, data, ph.loss_data)
    restore()
    graph.replay()
    torch.cuda.synchronize()
    runs.append([t.clone() for t in state])
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))
    assert int(runs[0][18]) == int(start[18]) + 1


def _replay_kernels(graph):
    """The kernels one replay of ``graph`` launches, from torch.profiler's
    kernel events (copies and sets left out); None when the trace holds no
    device event."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if str(ev.device_type).endswith("CUDA")]
    if not events:
        return None
    return sum(ev.count for ev in events
               if not ev.key.startswith(("Memcpy", "Memset")))


@pytest.mark.parametrize("shape", STEP_SHAPES)
def test_ga_replayed_step_launches_at_most_six_kernels_on_cuda(dev, shape):
    """A replayed GA step launches `ga_reparam`, the fused loss's two
    kernels and `ga_update`: at most 6 kernels (429-453 with autograd
    and the Python Adam), in both phases."""
    from torch_ga_scene import step_phase
    from starst3r_tpu_torch.alignment import ga
    for phase in (1, 2):
        ph, _, _ = step_phase("default", phase, device=dev,
                           scene=_step_scene(shape))
        graph = ga._capture(ph)
        n = _replay_kernels(graph)
        graph.reset()
        assert n is not None, "the profiler saw no device event"
        assert n <= 6, n


@pytest.mark.parametrize("case", ["plain", "frozen", "lora_frozen",
                                  "shared_mul"])
def test_ga_on_cuda_matches_cpu(dev, case):
    """The whole GA (15 + 8 steps) on the card, its replayed three-launch
    step, against the same GA on the CPU (autograd, the losses' chain):
    the lora test's tolerances (1e-4, poses in the root camera's frame).
    The frozen camera is the root, which pins the scene's free rigid
    motion (tests/test_torch_ga_chunk.py). Some other frozen sets make this
    short GA chaotic: float32 rounding grows past 1e-4 within the 23 steps
    on any route. On the CPU, the losses' chain and the fused loss under
    autograd (the card's route before these kernels) part by 3.9e-4 with
    cameras 1 and 3 frozen, and by 8.8e-4 with the lora basis and cameras
    0 and 1 frozen, where the float64 GA lands 6.6e-2 away."""
    from torch_ga_scene import ga_scene, lora_inputs
    from starst3r_tpu_torch.alignment.ga import run_global_alignment
    data, mst = ga_scene(4)
    kw, extra = dict(niter1=15, niter2=8), {}
    if case in ("frozen", "lora_frozen"):
        extra["freeze"] = np.array([True, False, False, False])
    if case == "lora_frozen":
        basis, coeffs = lora_inputs(data)
        kw.update(opt_depth=True, lora_depth=True, lora_k=16)
        extra.update(depth_basis=basis, depth_coeffs=coeffs)
    if case == "shared_mul":
        kw.update(shared_intrinsics=True, depth_mode="mul", opt_depth=True)
    cfg = stt.GAConfig(**kw)
    res = {str(dv): run_global_alignment(data, mst, cfg, device=dv,
                                         **extra)[0]
           for dv in ("cpu", dev)}
    c, g = res["cpu"], res[str(dev)]
    root = mst[0]
    rel = lambda m: (np.linalg.inv(m[root].astype(np.float64))[None] @ m)
    np.testing.assert_allclose(rel(g.cam2w.cpu().numpy()),
                               rel(c.cam2w.numpy()), atol=1e-4)
    np.testing.assert_allclose(g.K.cpu().numpy(), c.K.numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(g.depth.cpu().numpy(), c.depth.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(g.loss_coarse, c.loss_coarse, rtol=1e-4)
    np.testing.assert_allclose(g.loss_fine, c.loss_fine, rtol=1e-4)


def test_scene_checkpoint_round_trip_on_cuda(dev, tmp_path):
    from starst3r_tpu_torch.alignment.ga import GAParams
    rng = np.random.default_rng(3)
    scene = stt.Scene()
    scene.c2w = rng.normal(size=(2, 4, 4)).astype(np.float32)
    scene.intrinsics = rng.normal(size=(2, 3, 3)).astype(np.float32)
    scene.raw_imgs = [rng.uniform(-1, 1, (3, 8, 8)).astype(np.float32)
                      for _ in range(2)]
    scene.imgs = [rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
                  for _ in range(2)]
    scene.optim_params = GAParams(*[
        torch.randn(shape, device=dev) for shape in
        ((2, 2), (2,), (2, 4), (2, 3), (2,), (2, 16))])
    state = train_mod.init_gaussians(
        rng.normal(size=(40, 3)).astype(np.float32),
        rng.uniform(size=(40, 3)).astype(np.float32), SplatConfig(),
        pool_size=64)
    scene.gs_state = state._replace(n_alive=33)
    path = str(tmp_path / "scene.ckpt")
    scene.save(path)
    back = stt.Scene.load(path)
    assert back.device.type == "cuda"
    for a, b in zip(back.optim_params, scene.optim_params):
        assert a.is_cuda and torch.equal(a, b)
    for k, v in scene.gs_state.params.items():
        got = back.gs_state.params[k]
        assert got.is_cuda and torch.equal(got, v), k
    assert back.gs_state.n_alive == 33 and back.gs_state.step == 0
    assert back.gs_state.generator.device.type == "cuda"
    np.testing.assert_array_equal(np.stack(back.raw_imgs),
                                  np.stack(scene.raw_imgs))
    np.testing.assert_array_equal(back.c2w, scene.c2w)


def test_model_checkpoint_round_trip_on_cuda(dev, tmp_path):
    model = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(), seed=4)
    path = str(tmp_path / "model")
    model.save_pretrained(path)
    back = stt.Mast3rModel.from_pretrained(path + ".npz")
    assert back.device.type == "cuda"
    want = model.state_dict()
    got = back.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].is_cuda and torch.equal(got[k], want[k]), k
    rng = np.random.default_rng(5)
    imgs = [torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3)).astype(
        np.float32)).to(dev) for _ in range(2)]
    a = model.infer_pair_batch(*imgs)
    b = back.infer_pair_batch(*imgs)
    for k in a:
        np.testing.assert_allclose(b[k].cpu().numpy(), a[k].cpu().numpy(),
                                   atol=1e-6, err_msg=k)


def _launches():
    return {"composite_fwd_packed": comp.composite_packed_cuda.launches,
            "composite_bwd_packed": comp.composite_packed_slots_cuda.launches}


def test_cli_end_to_end_on_cuda(dev, tmp_path):
    import json
    import os

    from PIL import Image
    from starst3r_tpu_torch import cli
    from starst3r_tpu_torch.io.ply import load_ply

    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    rng = np.random.default_rng(6)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, size=(64, 64, 3)).astype(
            np.uint8)).save(imgdir / f"im_{i}.png")
    out = str(tmp_path / "out")
    ckpt = os.path.join(out, "scene.ckpt")
    runs = {
        "reconstruct": ["reconstruct", "--imgdir", str(imgdir), "--out", out,
                        "--res", "64", "--preset", "tiny", "--ga-iters1",
                        "20", "--ga-iters2", "10", "--gs-iters", "5",
                        "--conf-thres", "1.0", "--incremental-batch", "2"],
        "train-gs": ["train-gs", "--scene", ckpt, "--iters", "5"],
        "render-path": ["render-path", "--scene", ckpt, "--out",
                        str(tmp_path / "frames"), "--steps", "4"],
        "export-ply": ["export-ply", "--scene", ckpt, "--out",
                       str(tmp_path / "g.ply")],
    }
    for name, args in runs.items():
        before = _launches()
        assert cli.main(args) == 0, name
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in _launches().items()}
        if name in ("reconstruct", "train-gs"):
            assert min(ran.values()) > 0, (name, ran)
        elif name == "render-path":
            assert ran["composite_fwd_packed"] > 0, ran
    for f in ("scene.ckpt", "points.ply", "c2w.npy", "intrinsics.npy",
              "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, f)), f
    frames = sorted(os.listdir(tmp_path / "frames"))
    assert len(frames) == 5
    im = np.asarray(Image.open(tmp_path / "frames" / frames[0]))
    assert im.shape == (64, 64, 3)
    pts, _ = load_ply(os.path.join(out, "points.ply"))
    assert pts.shape[0] > 0 and np.isfinite(pts).all()
    with open(os.path.join(out, "metrics.jsonl")) as f:
        (load,) = [r for r in map(json.loads, f)
                   if r["event"] == "load_images"]
    assert load["impl"] == "native"


def test_trace_if_on_cuda_writes_a_trace(dev, tmp_path):
    import json
    import os

    from starst3r_tpu_torch.utils.profiling import trace_if
    with trace_if("matmul", str(tmp_path)):
        a = torch.randn(256, 256, device=dev)
        (a @ a).sum().item()
    files = [f for f in os.listdir(tmp_path / "matmul")
             if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / "matmul" / files[0]) as f:
        trace = json.load(f)
    # the device events are not asserted: torch.profiler's trace on the
    # card has been seen to hold none
    assert trace["traceEvents"]


def test_nccl_refuses_two_ranks_on_one_card(dev, tmp_path):
    """`parallel.initialize_distributed` never trades NCCL for another
    backend: two ranks that ask for NCCL on one card both raise, before
    any collective."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from starst3r_tpu_torch.parallel import initialize_distributed"
            "\ntry:\n"
            "    initialize_distributed(sys.argv[1], 2, int(sys.argv[2]),"
            " local_rank=0)\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n"
            "    sys.exit(0)\n"
            "sys.exit(3)\n")
    store = f"file://{tmp_path}/store"
    procs = [subprocess.Popen([sys.executable, "-c", code, store, str(r)],
                              cwd=root, env={**os.environ,
                                             "PYTHONPATH": root},
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "one rank per card" in out, out


def test_sharded_paths_on_several_cards(dev, tmp_path):
    """tests/test_torch_parallel.py's sharded training (with and without
    MCMC pruning), state placement, pair-parallel inference and tensor
    parallelism on every card of the machine, one rank per card over NCCL
    (`tests/torch_parallel_workers.py`), against the meshless calls on one
    card with the CPU tests' tolerances. Skips with fewer than two cards:
    NCCL runs one rank per card."""
    import os

    import torch_parallel_workers as workers
    from starst3r_tpu_torch.splat.train import init_gaussians, run_optim

    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more cards: NCCL runs one rank per card")
    tmp = str(tmp_path)
    torch.save(stt.Mast3rModel.init_random(
        stt.ModelConfig.tiny(), seed=3, device="cpu").state_dict(),
        os.path.join(tmp, "weights.pt"))
    rng = np.random.default_rng(1)
    hw = (32, 32)
    inp = {"infer_imgs": rng.uniform(-1, 1, size=(3, 3) + hw).astype(
               np.float32),
           "infer_pairs": np.array([(0, 1), (1, 0), (0, 2), (2, 0), (1, 2),
                                    (2, 1)]),
           "tp_img1": rng.uniform(-1, 1, size=(4,) + hw + (3,)).astype(
               np.float32),
           "tp_img2": rng.uniform(-1, 1, size=(4,) + hw + (3,)).astype(
               np.float32)}
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    jobs = ["optim", "placement", "infer"] + (["tp"] if world % 2 == 0
                                              else [])
    workers.join_world(workers.start_world(world, tmp, jobs, "cuda"))

    pts, cols, gt, w2c, K = workers.gs_inputs()
    cfg = SplatConfig()
    state, losses = run_optim(init_gaussians(pts, cols, cfg, device=dev),
                              gt, w2c, K, workers.GS_STEPS, cfg)
    out = workers.result(tmp, "optim", world)
    np.testing.assert_allclose(out["losses"], losses, rtol=2e-4)
    np.testing.assert_allclose(out["means"],
                               state.params["means"].cpu().numpy(),
                               atol=1e-5)
    state, losses = workers.run_pruning(device=dev)
    assert int(out["n_alive"]) == state.n_alive > workers.GS_N
    np.testing.assert_allclose(out["losses_prune"], losses, rtol=2e-4)
    for k, v in state.params.items():
        np.testing.assert_allclose(out[f"prune_{k}"], v.cpu().numpy(),
                                   atol=1e-5, err_msg=k)

    n = 8 * 16
    rows = np.arange(n * 3, dtype=np.float32).reshape(-1, 3)
    gen0 = workers.result(tmp, "placement", world)["gen"]
    for r in range(world):
        got = workers.result(tmp, "placement", world, r)
        lo, hi = r * n // world, (r + 1) * n // world
        np.testing.assert_array_equal(got["means"], rows[lo:hi])
        assert (int(got["step"]), int(got["n_alive"])) == (7, 100)
        np.testing.assert_array_equal(got["gen"], gen0)

    model = workers.tiny_model(tmp, dev)
    preds = model.infer_pairs(list(inp["infer_imgs"]),
                              [tuple(p) for p in inp["infer_pairs"]])
    out = workers.result(tmp, "infer", world)
    for f in ("pts1", "desc2", "conf1", "desc_conf2"):
        want = np.stack([getattr(p, f).cpu().numpy() for p in preds])
        np.testing.assert_allclose(out[f], want, atol=1e-3, err_msg=f)
    if "tp" in jobs:
        ref = model.infer_pair_batch(
            torch.as_tensor(inp["tp_img1"], device=dev),
            torch.as_tensor(inp["tp_img2"], device=dev))
        out = workers.result(tmp, "tp", world)
        for f in ("pts1", "conf2", "desc1", "desc_conf2"):
            np.testing.assert_allclose(out[f], ref[f].cpu().numpy(),
                                       atol=2e-3, err_msg=f)


def test_rasterize_impl_auto_on_cuda(dev):
    """`rasterize(..., impl="auto")`, the JAX spelling, is the default
    call on the card: the same images, K1 launched; the JAX backends raise
    rather than route a CUDA tensor to the plain version."""
    args = [a.to(dev) for a in _scene()]
    kw = dict(width=32, height=32, sh_degree=1, tile_size=16,
              max_tiles_per_gaussian=9, max_per_tile=128, chunk=128)
    rgb_d, a_d, _ = rasterize(*args, **kw)
    before = comp.composite_packed_cuda.launches
    rgb_a, a_a, _ = rasterize(*args, *kw.values(), "auto")
    torch.cuda.synchronize()
    assert comp.composite_packed_cuda.launches == before + 1
    assert torch.equal(rgb_a, rgb_d) and torch.equal(a_a, a_d)
    for impl in ("pallas", "xla", "ref"):
        with pytest.raises(ValueError):
            rasterize(*args, **kw, impl=impl)


def test_native_build_force_rebuilds(dev, tmp_path, monkeypatch):
    """`native.build(force=True)` compiles the library anew over the file
    and the next call loads it."""
    import os
    from starst3r_tpu_torch import native
    from starst3r_tpu_torch.utils import compile_cache
    monkeypatch.setattr(compile_cache, "_dir", None)
    stt.utils.enable_compilation_cache(tmp_path)
    assert native.available()
    so = native._lib_path()
    ino = os.stat(so).st_ino
    assert native.build(force=True) and os.stat(so).st_ino != ino
    assert native.available() and native.hash64(b"x") == native.hash64(b"x")


def test_compilation_cache_builds_a_kernel_there(dev, tmp_path,
                                                 monkeypatch):
    """After `enable_compilation_cache(path)` a kernel builds under
    ``path`` and launches from there."""
    from starst3r_tpu_torch.utils import compile_cache
    monkeypatch.setattr(compile_cache, "_dir", None)
    stt.utils.enable_compilation_cache(tmp_path)
    gen = torch.Generator(device=dev).manual_seed(0)
    packed = torch.randn((64, 9), generator=gen, device=dev)
    gidx = torch.randint(0, 64, (4, 8), generator=gen, device=dev,
                         dtype=torch.int32)
    valid = torch.rand((4, 8), generator=gen, device=dev) < 0.7
    before = gat.gather_entries_cuda.launches
    got = gat.gather_entries_cuda(packed, gidx, valid)
    torch.cuda.synchronize()
    assert gat.gather_entries_cuda.launches == before + 1
    assert any(p.name.startswith("gather_entries_")
               for p in tmp_path.glob("*.so"))
    assert torch.equal(got, gat.gather_entries_plain(packed, gidx, valid))


# ---------------------------------------------------------------------------
# Determinism: K2's packed gradient summed per Gaussian by the row-sum
# kernel, the polish's normal equations likewise.

def _packed_bwd_inputs(case, dev):
    """A packed case with the forward's outputs and seeded pixel
    gradients: (packed, gidx, counts, ent, fwd outputs, g_rgb, g_alpha,
    geometry)."""
    packed, gidx, counts, tile, h, w, tw, th = _packed_case(case, dev)
    ent = gat.gather_entries_plain(packed, gidx,
                                   comp.slot_valid(gidx, counts))
    fwd = comp.composite_tiles_cuda(ent, counts, h, w, tile, tw, th)
    c = counts.shape[0]
    gen = torch.Generator(device=dev).manual_seed(7)
    g_rgb = torch.randn((c, h, w, 3), generator=gen, device=dev)
    g_alpha = torch.randn((c, h, w), generator=gen, device=dev)
    return (packed, gidx, counts, ent, fwd, g_rgb, g_alpha,
            (h, w, tile, tw, th))


@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_bwd_slots_equal_entries_route(dev, case):
    """K2's packed route stores each slot's gradient: equal bit for bit to
    the entries route's grad_entries on the same case (the staging
    differs, the arithmetic does not); the slots past the counts, and
    those the walk did not reach, are 0 on both."""
    packed, gidx, counts, ent, fwd, g_rgb, g_alpha, geo = \
        _packed_bwd_inputs(case, dev)
    rgb, _, tfin, done = fwd
    before = (comp.composite_packed_slots_cuda.launches,
              row_sum.gather_rows_bwd_cuda.launches)
    slots = comp.composite_packed_slots_cuda(packed, gidx, counts, rgb, tfin,
                                             done, g_rgb, g_alpha, *geo)
    want = comp.composite_tiles_bwd_cuda(ent, counts, rgb, tfin, done,
                                         g_rgb, g_alpha, *geo)
    torch.cuda.synchronize()
    assert (comp.composite_packed_slots_cuda.launches,
            row_sum.gather_rows_bwd_cuda.launches) == (before[0] + 1,
                                                    before[1])
    assert slots.shape == (gidx.numel(), 9)
    assert torch.equal(slots, want.reshape(-1, 9))
    assert float(slots.abs().max()) > 0


@pytest.mark.parametrize("case", PACKED_CASES)
def test_packed_bwd_table_is_the_in_order_row_sum(dev, case):
    """The packed backward's table is `_gather_rows_bwd_in_order` of its
    per-slot gradient through `packed_csr`, bit for bit; one row-sum
    launch a backward; two launches give the same bits."""
    packed, gidx, counts, ent, fwd, g_rgb, g_alpha, geo = \
        _packed_bwd_inputs(case, dev)
    rgb, _, tfin, done = fwd
    args = (packed, gidx, counts, rgb, tfin, done, g_rgb, g_alpha, *geo)
    before = (comp.composite_packed_slots_cuda.launches,
              row_sum.gather_rows_bwd_cuda.launches)
    got = comp.composite_packed_bwd_cuda(*args)
    again = comp.composite_packed_bwd_cuda(*args)
    slots = comp.composite_packed_slots_cuda(*args)
    torch.cuda.synchronize()
    assert (comp.composite_packed_slots_cuda.launches,
            row_sum.gather_rows_bwd_cuda.launches) == (before[0] + 3,
                                                    before[1] + 2)
    order, offsets = comp.packed_csr(gidx, counts, packed.shape[0])
    assert int(offsets[-1]) == int(counts.long().sum())
    want = row_sum._gather_rows_bwd_in_order(slots, order, offsets)
    assert torch.equal(got, want)
    assert torch.equal(got, again)


def test_gather_entries_backward_is_the_row_sum(dev):
    """The standalone gather's backward on the card: the valid slots'
    gradients summed per row in a fixed order, equal to the in-order sum
    bit for bit and to index_add_ within 1e-6 of the largest value."""
    packed, gidx, counts, *_ = _packed_case("multichunk", dev)
    valid = comp.slot_valid(gidx, counts)
    p = packed.clone().requires_grad_(True)
    cot = torch.randn(tuple(gidx.shape) + (9,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(3))
    before = row_sum.gather_rows_bwd_cuda.launches
    (got,) = torch.autograd.grad(gat.gather_entries(p, gidx, valid), p, cot)
    (again,) = torch.autograd.grad(gat.gather_entries(p, gidx, valid), p,
                                   cot)
    assert row_sum.gather_rows_bwd_cuda.launches == before + 2
    assert torch.equal(got, again)
    want = row_sum._gather_rows_bwd_in_order(
        cot.reshape(-1, 9), *row_sum.masked_csr(
            gidx.reshape(-1), valid.reshape(-1), packed.shape[0]))
    assert torch.equal(got, want)
    plain = torch.zeros_like(packed).index_add_(
        0, gidx.reshape(-1), (cot * valid[..., None]).reshape(-1, 9))
    _assert_packed_grad(got, plain)


def _train_case(dev):
    """A small scene, a pool with headroom and a refine at step 20."""
    import dataclasses
    rng = np.random.default_rng(4)
    n, c = 600, 3
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    pts[:, 2] += 3.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    gt = torch.from_numpy(rng.uniform(size=(c, 48, 64, 3)).astype(
        np.float32)).to(dev)
    w2c = torch.eye(4).repeat(c, 1, 1)
    w2c[:, 0, 3] = torch.tensor([0.0, 0.1, -0.1])
    K = torch.tensor([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]]).repeat(
        c, 1, 1)
    cfg = dataclasses.replace(SplatConfig(), mcmc_refine_start=20,
                              mcmc_refine_every=20)
    state = train_mod.init_gaussians(pts, cols, cfg, pool_size=2 * n,
                                     device=dev)
    return state, gt, w2c.to(dev), K.to(dev), cfg


def _copy_state(state):
    gen = torch.Generator(device=state.generator.device)
    gen.set_state(state.generator.get_state())
    copy = lambda d: {k: v.clone() for k, v in d.items()}
    return state._replace(
        params=copy(state.params), generator=gen,
        opt_state=state.opt_state._replace(mu=copy(state.opt_state.mu),
                                           nu=copy(state.opt_state.nu)))


def test_run_optim_twice_is_bit_for_bit(dev):
    """Two trainings of 30 steps with one MCMC refine from one state: the
    same losses and parameters bit for bit; the row sum launched once per
    packed backward."""
    state, gt, w2c, K, cfg = _train_case(dev)
    runs = []
    for _ in range(2):
        before = (comp.composite_packed_slots_cuda.launches,
                  row_sum.gather_rows_bwd_cuda.launches)
        st, losses = train_mod.run_optim(_copy_state(state), gt, w2c, K, 30,
                                         cfg, enable_pruning=True)
        torch.cuda.synchronize()
        assert (comp.composite_packed_slots_cuda.launches - before[0]
                == row_sum.gather_rows_bwd_cuda.launches - before[1] == 30)
        runs.append((st, losses))
    (a, la), (b, lb) = runs
    assert a.n_alive == b.n_alive > state.n_alive      # the refine grew it
    assert la == lb and all(np.isfinite(la))
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    for k, v in a.opt_state.nu.items():
        assert torch.equal(v, b.opt_state.nu[k]), k


def test_polish_is_bit_for_bit_on_cuda(dev):
    """The polish's systems built twice on the card, and whole lm_refine
    and schur_refine runs twice: the same bits."""
    from starst3r_tpu_torch.alignment import lm, schur
    d = _planted_ba(np.random.default_rng(0), c=6, npts=40, window=5)
    thetas = _thetas(d["noisy"], d["focals"]).to(dev)
    corr = [d[k] for k in ("img1", "idx1", "img2", "idx2", "conf",
                           "core_pix", "pps", "depths")]
    tracks = schur.build_tracks(d["img1"], d["idx1"], d["img2"], d["idx2"],
                                d["conf"], 6, d["core_pix"].shape[0],
                                max_obs=8)
    track_args = [tracks.cam, tracks.pt, tracks.w, d["core_pix"], d["pps"],
                  d["depths"]]
    before = row_sum.gather_rows_bwd_cuda.launches
    for fn, data in ((lm._normal_eqs, corr),
                     (schur._reduced_system, track_args)):
        a, b = (fn(thetas, *_to(dev, *data)) for _ in range(2))
        for x, y in zip(a, b):
            assert torch.equal(x, y), fn.__name__
    assert row_sum.gather_rows_bwd_cuda.launches > before
    base = (d["noisy"], d["focals"], d["pps"], d["depths"], d["core_pix"])
    for run in (lambda: lm.lm_refine(*base, d["img1"], d["idx1"], d["img2"],
                                     d["idx2"], d["conf"], iters=6,
                                     device=dev),
                lambda: schur.schur_refine(*base, tracks, iters=6,
                                           device=dev)):
        (c1, f1, k1), (c2, f2, k2) = run(), run()
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(f1, f2)
        assert k1 == k2


def test_sample_targets_is_deterministic_on_cuda(dev):
    """The refine's categorical draw at a pool's size (past the few
    thousand entries where the card's default float scan starts to give
    other bits): three draws from one generator state are equal."""
    from starst3r_tpu_torch.splat.mcmc import sample_targets
    n = 300_000
    w = torch.rand(n, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(0))
    live = torch.ones(n, dtype=torch.bool, device=dev)
    draws = [sample_targets(w, live, n, torch.Generator(
        device=dev).manual_seed(1)) for _ in range(3)]
    assert all(torch.equal(draws[0], d) for d in draws[1:])
    assert not torch.are_deterministic_algorithms_enabled()


# -- VGGT: the fused attention route, and the network at published widths

# the fused route's output within FUSED_ATTN_TOL of the largest magnitude
# of float32 attention on the same bfloat16 inputs: its bfloat16 output
# rounds by 2^-9 of a value, and flash accumulates in float32
FUSED_ATTN_TOL = 8e-3
# VGGT-1B on the card (bfloat16 aggregator, float32 heads) against the
# float32 reference: each output's RMS gap in the heads' own values over
# the larger of its RMS and the median output's, the benchmark's
# `net_gap` measure (benchmark/benchlib/kinds/mvrecon.py), within the
# cell's limit (benchmark/checks/vggt1b-recon32.json): sound 32-view
# scenes read 0.0020-0.0089, the float8 control 0.031-0.061; these 4
# views 0.0042
VGGT_NET_TOL = 0.02


def _attention_f32(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    p = torch.softmax(s * q.shape[-1] ** -0.5, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float())


@pytest.mark.parametrize("t", [256, 1041, 4096, 8192])
def test_fused_sdpa_matches_the_einsum_route(dev, t):
    from starst3r_tpu_torch.ops import attention
    gen = torch.Generator(device=dev).manual_seed(t)
    b = 2 if t <= 4096 else 1
    q, k, v = (torch.randn(b, t, 16, 64, device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    before = attention.fused_sdpa.launches
    got = attention.fused_sdpa(q, k, v)
    assert attention.fused_sdpa.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = _attention_f32(q, k, v)
    einsum = attention.sdpa(q, k, v).float()
    scale = float(want.abs().max())
    err = float((got.float() - want).abs().max())
    err_einsum = float((einsum - want).abs().max())
    assert err <= FUSED_ATTN_TOL * scale, (err, err_einsum, scale)
    assert err <= 2.0 * err_einsum + 1e-3 * scale, (err, err_einsum)


def test_fused_sdpa_raises_where_flash_cannot_run(dev):
    """float32 inputs on the card: the flash kernel refuses them and the
    route raises; no other kernel answers in its place."""
    from starst3r_tpu_torch.ops import attention
    q = torch.randn(1, 128, 16, 64, device=dev)
    before = attention.fused_sdpa.launches
    with pytest.raises(RuntimeError):
        attention.fused_sdpa(q, q, q)
    assert attention.fused_sdpa.launches == before


def _head_space(key, x):
    x = x.double()
    if key == "depth":
        return torch.log(x.clamp_min(1e-30))
    if key.endswith("conf"):
        return torch.log((x - 1.0).clamp_min(1e-30))
    if key == "world_points":
        return torch.sign(x) * torch.log1p(x.abs())
    return x


# the float32 kernel against float64 attention: float32 sums in another
# order and exp2f's ulps, well inside the rect test's 2e-5 on the network
ROPE_ATTN_F32_TOL = 2e-5


@pytest.mark.parametrize("b, grid, heads, kind, grid_k", [
    (16, (24, 32), 16, "self", None),    # the encoder at 512 x 384
    (8, (24, 32), 12, "self", None),     # the decoder at 512 x 384
    (8, (24, 32), 12, "cross", None),
    (16, (10, 14), 16, "self", None),    # 224 x 160: 140 keys, ragged
    (8, (10, 14), 12, "cross", None),
    (4, (10, 14), 12, "cross", (7, 9)),  # 140 queries, 63 keys
    (2, (5, 20), 4, "none", None),       # no rotation
])
def test_rope_attention_matches_the_plain_version(dev, b, grid, heads, kind,
                                                  grid_k):
    from starst3r_tpu_torch.ops import attention
    args = attention_inputs(dev, b, grid, heads, 64, kind, torch.bfloat16,
                            seed=b + heads, grid_k=grid_k)
    before = attention.rope_attention.launches
    got = attention.rope_attention(*args)
    assert attention.rope_attention.launches == before + 1
    q = args[0]
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous() and bool(torch.isfinite(got).all())
    want = attention_f64(*args)
    plain = attention._rope_attention_plain(*args).double()
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max())
    err_plain = float((plain - want).abs().max())
    assert err <= FUSED_ATTN_TOL * scale, (err, err_plain, scale)
    assert err <= 2.0 * err_plain + 1e-3 * scale, (err, err_plain, scale)


@pytest.mark.parametrize("d", [24, 32, 64])
@pytest.mark.parametrize("grid, kind", [((4, 6), "self"), ((7, 10), "cross"),
                                        ((3, 3), "self")])
def test_rope_attention_in_float32(dev, d, grid, kind):
    """The `tiny` preset's head sizes (24, 32) and a bfloat16 preset's (64)
    run in float32: 24, 70 (three tiles of 32, the last ragged) and 9
    keys."""
    from starst3r_tpu_torch.ops import attention
    args = attention_inputs(dev, 3, grid, 2, d, kind, torch.float32,
                            seed=d)
    got = attention.rope_attention(*args)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    want = attention_f64(*args)
    scale = float(want.abs().max())
    assert float((got.double() - want).abs().max()) \
        <= ROPE_ATTN_F32_TOL * scale


def test_rope_attention_raises_on_what_it_has_no_kernel_for(dev):
    """A head size or dtype with no instantiation, tables with a batch,
    keys of another head count, and inputs that want a gradient raise
    ValueError on the card, launching nothing."""
    from starst3r_tpu_torch.ops import attention
    q, k, v, rq, rk = attention_inputs(dev, 2, (4, 4), 2, 64, "self",
                                       torch.bfloat16, seed=0)
    before = attention.rope_attention.launches
    bad = [
        attention_inputs(dev, 2, (4, 4), 2, 32, "self", torch.bfloat16,
                         seed=0),
        attention_inputs(dev, 2, (4, 4), 2, 64, "self", torch.float16,
                         seed=0),
        attention_inputs(dev, 2, (4, 4), 2, 48, "self", torch.float32,
                         seed=0),
        (q, k, v, tuple(t.expand(2, -1, -1) for t in rq), rk),
        (q, k[:, :, :1], v[:, :, :1], rq, rk),
        (q.float().requires_grad_(), k.float(), v.float(), rq, rk),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            attention.rope_attention(*args)
    assert attention.rope_attention.launches == before


def test_mast3r_forward_launches_the_attention_kernel(dev):
    """The tiny model's forward on the card: one kernel launch a block's
    attention (enc_depth + 4 dec_depth), none of the flash route's."""
    from starst3r_tpu_torch.ops import attention
    cfg = stt.ModelConfig.tiny()
    model = stt.Mast3rModel.init_random(cfg, seed=0, device=dev)
    img = torch.rand(2, 64, 96, 3, device=dev) * 2 - 1
    before = attention.rope_attention.launches
    flash = attention.fused_sdpa.launches
    out = model.infer_pair_batch(img, img.flip(0))
    assert (attention.rope_attention.launches - before
            == cfg.enc_depth + 4 * cfg.dec_depth)
    assert attention.fused_sdpa.launches == flash
    assert all(bool(torch.isfinite(x).all()) for x in out.values())


def test_vggt_1b_on_four_views_against_the_reference(dev):
    """VGGT-1B at 4 views of 518 x 392 on random weights: the program on
    the card against the float32 reference (tests/vggt_reference.py, its
    attention in blocks), both on the program's state dict."""
    import vggt_reference as ref
    import starst3r_tpu_torch as stt
    from starst3r_tpu_torch.ops import attention
    cfg = stt.VGGTConfig.vggt_1b()
    model = stt.VGGTModel.init_random(cfg, seed=0, device=dev)
    imgs = torch.rand(4, 3, 392, 518, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(1))
    before = attention.fused_sdpa.launches
    got = model.infer(list(imgs.cpu().numpy()))
    assert attention.fused_sdpa.launches - before == 24 + 2 * 24
    rcfg = dict(patch_size=14, img_size=518, embed_dim=1024, enc_depth=24,
                num_heads=16, mlp_ratio=4.0, num_register_tokens=4,
                depth=24, head_layers=[4, 11, 17, 23], dpt_features=256,
                dpt_out_channels=[256, 512, 1024, 1024], dpt_last_dim=32,
                frames_chunk_size=8, camera_trunk_depth=4,
                camera_num_heads=16, camera_iterations=4)
    with torch.no_grad():
        want = ref.VGGT(model.state_dict(), rcfg).forward(imgs)
    keys = ("pose_enc", "depth", "depth_conf", "world_points",
            "world_points_conf")
    rms = lambda x: float(x.pow(2).mean().sqrt())
    hr = {k: _head_space(k, want[k]) for k in keys}
    scale = {k: rms(hr[k]) for k in keys}
    med = float(np.median(list(scale.values())))
    gaps = {k: rms(_head_space(k, got[k]) - hr[k]) / max(scale[k], med)
            for k in keys}
    print("vggt-1b 4 views, gaps in head space:", gaps)
    assert all(np.isfinite(list(gaps.values())))
    assert float(np.mean(list(gaps.values()))) <= VGGT_NET_TOL, gaps
