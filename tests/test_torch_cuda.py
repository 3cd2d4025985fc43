"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the compositing forward (`composite_fwd.cu`) and backward
(`composite_bwd.cu`), on both routes (the gathered entries, and the
rasterizer's packed route, which stages each entry's row through the
binning's index and scatters the gradient into the table), the entry
gather (`gather_entries.cu`), and a training step on the card against the
same step on the CPU. Also the stock-PyTorch stages that must run in full
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
    staging differs); the packed backward against ``index_add_`` of the
    entries route's gradient: 1e-6 of each attribute's largest value (the
    same per-entry sums, added into the rows in another order);
  - a training step on the card against the CPU: the loss to 1e-4
    relative (other summation orders, and the kernels' own rounding), and
    each parameter's gradient (Adam's first moment after one step, 0.1
    times the gradient) within 2e-3 of the CPU's largest magnitude, the
    backward kernel's own tolerance;
  - the polish on the card against the CPU, on planted problems (the
    construction of tests/test_lm.py and tests/test_schur.py): the normal
    equations and the Schur system at the perturbed start within 1e-5 of
    their largest entry (the same products, added with atomics in another
    order), the cost to 1e-5 relative; the refined poses within 1e-3 of
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
  - checkpoints: bit for bit;
  - the command line (`python -m starst3r_tpu_torch`) on the card at the
    tiny preset: every subcommand exits 0 and writes its files, and the
    subcommands that render or train launch the packed compositing kernels;
    `utils.profiling.trace_if` writes a trace.
  - `parallel.initialize_distributed`: two processes asking for NCCL on
    one card both raise (no other backend is taken in its place);
  - on a machine with several cards, the sharded paths over NCCL (one rank
    per card) against the meshless calls on one card, with the CPU tests'
    tolerances (tests/test_torch_parallel.py); skips on one card.
"""

import numpy as np
import pytest
import torch

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.config import SplatConfig
from starst3r_tpu_torch.splat import composite as comp
from starst3r_tpu_torch.splat import gather as gat
from starst3r_tpu_torch.splat import train as train_mod
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
              (32, 40, 50, 96)]


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
                comp.composite_packed_bwd_cuda.launches,
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
            comp.composite_packed_bwd_cuda.launches,
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
    before = comp.composite_packed_bwd_cuda.launches
    got = comp.composite_packed_bwd_cuda(packed, gidx, counts, rgb, tfin,
                                         done, g_rgb, g_alpha, h, w, tile,
                                         tw, th)
    torch.cuda.synchronize()
    assert comp.composite_packed_bwd_cuda.launches == before + 1
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
                comp.composite_packed_bwd_cuda.launches)
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
            comp.composite_packed_bwd_cuda.launches) == (
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
    same products, summed with atomics in another order), the cost to
    1e-5 relative."""
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
            "composite_bwd_packed": comp.composite_packed_bwd_cuda.launches}


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
