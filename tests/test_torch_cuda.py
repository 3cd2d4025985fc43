"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the compositing forward (`composite_fwd.cu`) and backward
(`composite_bwd.cu`), the entry gather (`gather_entries.cu`), and a
training step on the card against the same step on the CPU.

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
  - a training step on the card against the CPU: the loss to 1e-4
    relative (other summation orders, and the kernels' own rounding), and
    each parameter's gradient (Adam's first moment after one step, 0.1
    times the gradient) within 2e-3 of the CPU's largest magnitude, the
    backward kernel's own tolerance.
"""

import numpy as np
import pytest
import torch

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.config import SplatConfig
from starst3r_tpu_torch.splat import composite as comp
from starst3r_tpu_torch.splat import gather as gat
from starst3r_tpu_torch.splat import train as train_mod
from starst3r_tpu_torch.splat.rasterize import (bin_gaussians, rasterize,
                                                tile_entries)

pytestmark = pytest.mark.cuda

ATOL = 1e-4
BWD_SCALED_TOL = 2e-3


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
    ent, counts = _case_entries("multichunk")
    e = ent.to(dev).requires_grad_(True)
    counts = counts.to(dev)
    fwd, bwd = (comp.composite_tiles_cuda.launches,
                comp.composite_tiles_bwd_cuda.launches)
    nonfinite = int(comp.CompositeTiles.nonfinite)
    rgb, alpha = comp.composite_tiles(e, counts, 32, 32, 16, 2, 2)
    (rgb.square().sum() + alpha.sum()).backward()
    torch.cuda.synchronize()
    assert comp.composite_tiles_cuda.launches == fwd + 1
    assert comp.composite_tiles_bwd_cuda.launches == bwd + 1
    assert e.grad.shape == e.shape and bool(torch.isfinite(e.grad).all())
    assert int(comp.CompositeTiles.nonfinite) == nonfinite


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


def test_train_step_on_cuda_matches_cpu(dev):
    """One train_step on the card (gather, forward and backward kernels)
    against the same step on the CPU (plain versions): the loss, and the
    gradients that reached Adam, which the loss alone does not show."""
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
                comp.composite_tiles_cuda.launches,
                comp.composite_tiles_bwd_cuda.launches)
    for d in ("cpu", dev):
        state = train_mod.init_gaussians(pts, cols, cfg, device=d)
        state, loss = train_mod.train_step(state, gt.to(d), w2c.to(d),
                                           K.to(d), 32, 32, cfg, c)
        losses[str(d)] = float(loss)
        moments[str(d)] = {k: v.cpu() for k, v in state.opt_state.mu.items()}
        assert all(bool(torch.isfinite(v).all())
                   for v in state.params.values())
    assert (gat.gather_entries_cuda.launches,
            comp.composite_tiles_cuda.launches,
            comp.composite_tiles_bwd_cuda.launches) == tuple(
                x + 1 for x in launches)
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
    args = _scene()
    kw = dict(width=32, height=32, sh_degree=1, tile_size=16,
              max_tiles_per_gaussian=9, max_per_tile=128)
    rgb_c, a_c, info_c = rasterize(*args, **kw)
    before = comp.composite_tiles_cuda.launches
    rgb_g, a_g, info_g = rasterize(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    assert comp.composite_tiles_cuda.launches == before + 1
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
    before = comp.composite_tiles_cuda.launches
    rgb, alpha, _ = scene.render_3dgs_original(64, 64)
    assert comp.composite_tiles_cuda.launches == before + 1
    assert rgb.shape == (3, 64, 64, 3) and bool(torch.isfinite(rgb).all())
