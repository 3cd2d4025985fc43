"""The cull box (`splat.composite.cull_boxes_plain`, the torch twin of
`csrc/composite_common.cuh::cull_box`) against the plain cull.

Both compositing kernels skip a (warp, entry) pair when the entry's cull box
misses the warp's pixels, so the box must hold every pixel at which
`composite_tiles_plain`'s rounded culls (sigma >= 0 and op * exp(-sigma) >
1/255) pass, or a kernel would drop a splat that the plain version draws.
No tolerance: one pixel outside its box fails. Inputs are made with numpy
from a seed; the degenerate, threshold, extreme and non-finite cases are
where rounding decides.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from starst3r_tpu_torch.splat import composite as comp
from starst3r_tpu_torch.splat.rasterize import tile_entries

TILE, TW, TH, K = 16, 3, 2, 256


def _passing(ent, tile, tw, th):
    """(C, T, K, P) bool: the plain version's culls, with its arithmetic."""
    px, py = comp._tile_pix(tw, th, tile, ent.device)
    px, py = px[None, :, None, :], py[None, :, None, :]
    dx = px - ent[..., 0:1]
    dy = py - ent[..., 1:2]
    sigma = (0.5 * (ent[..., 2:3] * dx * dx + ent[..., 4:5] * dy * dy)
             + ent[..., 3:4] * dx * dy)
    alpha = ent[..., 8:9] * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
    return (sigma >= 0.0) & (alpha > 1.0 / 255.0)


def _in_box(box, tile):
    p = torch.arange(tile * tile)
    lx, ly = p % tile, p // tile
    return ((lx >= box[..., 0:1]) & (lx <= box[..., 1:2])
            & (ly >= box[..., 2:3]) & (ly <= box[..., 3:4]))


def _means_and_colours(rng, ent, spread=4.0):
    """Means spread over each tile and ``spread`` px past it, some exactly
    on pixel centres (where the falloff is 1); random colours."""
    c, t, k = ent.shape[:3]
    for ti in range(t):
        x0, y0 = (ti % TW) * TILE, (ti // TW) * TILE
        ent[:, ti, :, 0] = rng.uniform(x0 - spread, x0 + TILE + spread,
                                       (c, k))
        ent[:, ti, :, 1] = rng.uniform(y0 - spread, y0 + TILE + spread,
                                       (c, k))
        on = rng.uniform(size=(c, k)) < 0.25
        ent[:, ti, :, 0][on] = np.floor(ent[:, ti, :, 0][on]) + 0.5
        ent[:, ti, :, 1][on] = np.floor(ent[:, ti, :, 1][on]) + 0.5
    ent[..., 5:8] = rng.uniform(0, 1, ent.shape[:3] + (3,))


def _random(rng):
    """Splats of 0.3 to 30 px across, any orientation and opacity."""
    ent = np.zeros((2, TW * TH, K, 9), np.float32)
    _means_and_colours(rng, ent)
    shape = ent.shape[:3]
    sa = 10.0 ** rng.uniform(-2.5, 1.0, shape)
    ent[..., 2] = sa * rng.uniform(0.1, 1.0, shape)
    ent[..., 4] = sa * rng.uniform(0.1, 1.0, shape)
    ent[..., 3] = (rng.uniform(-0.999, 0.999, shape)
                   * np.sqrt(ent[..., 2] * ent[..., 4]))
    ent[..., 8] = rng.uniform(0.0, 1.0, shape)
    return ent


def _degenerate(rng):
    """Near-singular conics as tests/test_torch_cuda.py builds them
    (b = -a (1 - 1e-6), sigma within rounding of 0 along a line), and
    conics just either side of the box's near-degenerate threshold."""
    ent = np.zeros((1, TW * TH, K, 9), np.float32)
    _means_and_colours(rng, ent, spread=0.0)
    shape = ent.shape[:3]
    s = rng.uniform(1e2, 1e4, shape)
    ent[..., 2] = s
    ent[..., 4] = s
    rho = np.where(rng.uniform(size=shape) < 0.5,
                   rng.uniform(0.999999, 1.0, shape),
                   np.sqrt(1.0 - rng.uniform(0.5e-3, 2e-3, shape)))
    ent[..., 3] = -s * rho
    ent[..., 8] = 1.0
    return ent


def _opacity_threshold(rng):
    """Opacities one ulp either side of 1/255 and a few ulp above it, on
    splats centred on pixels (sigma = 0 there, so only the opacity cull
    decides)."""
    ent = _random(rng)
    lim = np.float32(1.0 / 255.0)
    ops = np.array([np.nextafter(lim, np.float32(0)), lim,
                    np.nextafter(lim, np.float32(1)),
                    lim * np.float32(1.0000005), lim * np.float32(1.00001),
                    lim * np.float32(1.001)], np.float32)
    ent[..., 8] = ops[rng.integers(0, ops.size, ent.shape[:3])]
    return ent


def _extreme_conics(rng):
    """Conic coefficients of 1e-8 (splats wider than any tile) and 1e8
    (narrower than a pixel: pass only at a pixel centre within 1e-4 px),
    and the two mixed."""
    ent = _random(rng)
    shape = ent.shape[:3]
    pick = rng.integers(0, 4, shape)
    a = np.choose(pick, [1e-8, 1e8, 1e-8, 1e8])
    c = np.choose(pick, [1e-8, 1e8, 1e8, 1e-8])
    ent[..., 2] = a
    ent[..., 4] = c
    ent[..., 3] = rng.uniform(-0.5, 0.5, shape) * np.sqrt(a * c)
    ent[..., 8] = rng.uniform(0.05, 1.0, shape)
    return ent


def _ellipse_edge(rng):
    """Each entry's ellipse drawn through a pixel centre at its leftmost,
    rightmost, top or bottom point, where the box's edge lies: the conic is
    scaled so that sigma there is ln(255 op) to within 3e-7, and the
    rounding of sigma and of the exp decides the cull. A box as tight as
    the exact ellipse drops some of these pixels."""
    ent = np.zeros((2, TW * TH, K, 9), np.float32)
    shape = ent.shape[:3]
    ent[..., 5:8] = rng.uniform(0, 1, shape + (3,))
    op = rng.uniform(0.01, 1.0, shape)
    ent[..., 8] = op
    ang = rng.uniform(0, np.pi, shape)
    l1 = 10.0 ** rng.uniform(-2, 0.5, shape)
    l2 = l1 * rng.uniform(0.05, 1.0, shape)
    cs, sn = np.cos(ang), np.sin(ang)
    a = l1 * cs * cs + l2 * sn * sn
    c = l1 * sn * sn + l2 * cs * cs
    b = (l1 - l2) * cs * sn
    # the mean's offset from the pixel: along x at the point where the
    # ellipse's tangent is vertical (dy = -b dx / c), or along y where it
    # is horizontal
    along_x = rng.uniform(size=shape) < 0.5
    u = rng.uniform(1, 8, shape) * rng.choice([-1.0, 1.0], shape)
    dx = np.where(along_x, u, -b * u / a)
    dy = np.where(along_x, -b * u / c, u)
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    scale = (np.log(255.0 * op) * (1.0 + rng.uniform(-3e-7, 3e-7, shape))
             / sigma)
    t = np.arange(TW * TH)[None, :, None]
    ent[..., 0] = (t % TW) * TILE + rng.integers(0, TILE, shape) + 0.5 - dx
    ent[..., 1] = (t // TW) * TILE + rng.integers(0, TILE, shape) + 0.5 - dy
    ent[..., 2] = a * scale
    ent[..., 3] = b * scale
    ent[..., 4] = c * scale
    return ent


def _non_finite(rng):
    """NaN and +-inf in every attribute the cull reads."""
    ent = _random(rng)
    shape = ent.shape[:3]
    bad = np.array([np.nan, np.inf, -np.inf], np.float32)
    for attr in (0, 1, 2, 3, 4, 8):
        hit = rng.uniform(size=shape) < 0.08
        ent[..., attr][hit] = bad[rng.integers(0, 3, int(hit.sum()))]
    return ent


CASES = {"random": _random, "degenerate": _degenerate,
         "ellipse_edge": _ellipse_edge,
         "opacity_threshold": _opacity_threshold,
         "extreme_conics": _extreme_conics, "non_finite": _non_finite}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_passing_pixel_is_inside_its_box(case):
    ent = torch.from_numpy(CASES[case](np.random.default_rng(3)))
    box = comp.cull_boxes_plain(ent, TILE, TW, TH)
    assert box.shape == ent.shape[:3] + (4,) and box.dtype == torch.int32
    passing = _passing(ent, TILE, TW, TH)
    outside = passing & ~_in_box(box, TILE)
    assert int(outside.sum()) == 0, (
        f"{int(outside.sum())} passing pixels outside their box, entries "
        f"{torch.nonzero(outside.any(-1))[:5].tolist()}")
    # every case has entries that pass somewhere, so the check bites
    assert int(passing.sum()) > 0
    lo_hi = box.reshape(-1, 4)
    empty = (lo_hi[:, 0] > lo_hi[:, 1]) | (lo_hi[:, 2] > lo_hi[:, 3])
    assert bool(((lo_hi[~empty] >= 0) & (lo_hi[~empty] < TILE)).all())
    assert bool((lo_hi[empty] == torch.tensor([0, -1, 0, -1],
                                              dtype=torch.int32)).all())


def test_box_rule_at_its_edges():
    """Empty at opacity <= 1/255 and for NaN opacity; the whole tile for a
    near-degenerate conic, a non-finite attribute, a conic that is not
    positive definite, or an opacity whose clipped falloff stays above
    1/255; a small box for a small splat."""
    lim = np.float32(1.0 / 255.0)
    rows = {
        "op at 1/255": ([8.5, 8.5, 1, 0, 1, 1, 1, 1, lim], "empty"),
        "op NaN": ([8.5, 8.5, 1, 0, 1, 1, 1, 1, np.nan], "empty"),
        "degenerate": ([8.5, 8.5, 1e3, -1e3 * (1 - 1e-6), 1e3, 1, 1, 1, 1],
                       "whole"),
        "mean inf": ([np.inf, 8.5, 1, 0, 1, 1, 1, 1, 0.5], "whole"),
        "conic NaN": ([8.5, 8.5, np.nan, 0, 1, 1, 1, 1, 0.5], "whole"),
        "indefinite": ([8.5, 8.5, 1, 2, 1, 1, 1, 1, 0.5], "whole"),
        "negative": ([8.5, 8.5, -1, 0, -1, 1, 1, 1, 0.5], "whole"),
        "op 1e30": ([8.5, 8.5, 1, 0, 1, 1, 1, 1, 1e30], "whole"),
        "small": ([8.5, 4.5, 4, 0, 4, 1, 1, 1, 0.9], (6, 10, 2, 6)),
        "far away": ([1e6, 4.5, 4, 0, 4, 1, 1, 1, 0.9], "empty"),
    }
    ent = torch.tensor([r for r, _ in rows.values()],
                       dtype=torch.float32).reshape(1, 1, -1, 9)
    box = comp.cull_boxes_plain(ent, 16, 1, 1)[0, 0]
    want = {"empty": (0, -1, 0, -1), "whole": (0, 15, 0, 15)}
    for (name, (_, kind)), got in zip(rows.items(), box.tolist()):
        assert tuple(got) == want.get(kind, kind), (name, got)


def test_boxes_skip_most_pairs_on_a_scene():
    """On a scene of small splats (the kernels' test scene: 1400 Gaussians,
    two cameras, 32 px) the boxes hold a small share of the (pixel, entry)
    pairs a kernel without them would walk, and of the (warp, entry) pairs:
    the box is not the whole tile."""
    rng = np.random.default_rng(0)
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
    K = np.tile(np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]],
                         np.float32)[None], (2, 1, 1))
    args = [torch.from_numpy(a) for a in (means, quats, scales, opac, sh,
                                          w2c, K)]
    ent, counts, _ = tile_entries(*args, 32, 32, 1, 16, 4, 512)
    box = comp.cull_boxes_plain(ent, 16, 2, 2)
    live = (torch.arange(ent.shape[2]) < counts[..., None].long())
    assert int(live.sum()) > 1000
    passing = _passing(ent, 16, 2, 2) & live[..., None]
    inside = _in_box(box, 16) & live[..., None]
    assert int((passing & ~inside).sum()) == 0
    walked = int(live.sum()) * 256
    assert int(inside.sum()) < 0.2 * walked, int(inside.sum()) / walked
    assert int(passing.sum()) > 0.02 * walked
    # warps of 8 x 4 pixels, 2 across and 4 down the tile
    bx = box[live]
    nonempty = (bx[:, 0] <= bx[:, 1]) & (bx[:, 2] <= bx[:, 3])
    warps = ((bx[:, 1] // 8 - bx[:, 0] // 8 + 1)
             * (bx[:, 3] // 4 - bx[:, 2] // 4 + 1) * nonempty)
    assert int(warps.sum()) < 0.5 * 8 * int(live.sum())
