"""The port's rasterizer, matching and image loading held to the JAX
package off the square (tests/test_torch_rect.py holds the slice and the
network there):

  - the rasterizer with width != height and a tile grid (tw != th) whose
    last column and row overhang the image: the binning equal to JAX's,
    the forward within 1e-5 of JAX `impl="ref"` and 1e-4 of the Pallas
    forward (in interpret mode), the gradients within 2e-3 of each JAX
    gradient's largest magnitude (tests/test_torch_rasterize.py's and
    tests/test_torch_grad.py's tolerances);
  - matching on a 64 x 96 grid: `subsample_grid_indices`, `match_pair` and
    `refine_matches` equal to JAX's index for index, on
    tests/test_torch_geometry.py's inputs at that size;
  - `load_images` of 4:3, 3:4 and 16:9 PNGs at size 224 and 512, on both
    routes: shapes and pixels equal to JAX's.
"""

import importlib

import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

import jax.numpy as jnp

import starst3r_tpu as st
from starst3r_tpu.ops import matching as jmatch

import starst3r_tpu_torch as stt
from starst3r_tpu_torch import native
from starst3r_tpu_torch.ops import matching as tmatch

from test_torch_geometry import _min_gap, _predictions
from test_torch_grad import NAMES, _assert_scaled, _jax_grads, _port_grads
from test_torch_rasterize import _j, _scene, _t

jr = importlib.import_module("starst3r_tpu.splat.rasterize")
tr = importlib.import_module("starst3r_tpu_torch.splat.rasterize")

H, W = 64, 96
# matching's inputs: the best and second-best similarity of every grid cell
# at least this far apart, ~100x the float32 rounding of an 8-term dot
# product of unit vectors, so argmax cannot flip between summation orders
# (tests/test_torch_geometry.py asks 1e-4 of its 64 cells; 96 cells of the
# same construction come closer than that)
MIN_GAP = 1e-5
# the rasterizer: 40 x 24 pixels in 16 px tiles, a 3 x 2 grid whose last
# column and row overhang the image
RECT = dict(width=40, height=24, sh_degree=1, tile_size=16,
            max_tiles_per_gaussian=9, max_per_tile=128, chunk=32)


def _rect_scene(n=96):
    """tests/test_torch_rasterize.py's scene, its principal point moved to
    the centre of the 40 x 24 image."""
    args = list(_scene(n=n))
    K = args[6].copy()
    K[:, 0, 2], K[:, 1, 2] = RECT["width"] / 2, RECT["height"] / 2
    args[6] = K
    return tuple(args)


def test_binning_matches_jax_off_the_square():
    args = _rect_scene()
    kw = RECT
    bins = jr.bin_gaussians(
        *_j(args), width=kw["width"], height=kw["height"], sh_degree=1,
        tile_size=kw["tile_size"],
        max_tiles_per_gaussian=kw["max_tiles_per_gaussian"],
        max_per_tile=kw["max_per_tile"])
    tw, th = 3, 2
    proj = tr.project_gaussians(*_t(args), 1)
    gidx, valid, counts, overflow, n_clip, _ = tr._bin_gaussians(
        proj, tw, th, kw["tile_size"], kw["max_tiles_per_gaussian"],
        kw["max_per_tile"])
    assert tuple(counts.shape) == (2, tw * th)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(bins.ent_valid))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(bins.counts))
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(bins.overflow))
    np.testing.assert_array_equal(n_clip.numpy(), np.asarray(bins.n_clipped))
    local = (gidx - torch.arange(2)[:, None, None] * args[0].shape[0]).numpy()
    v = np.asarray(bins.ent_valid)
    np.testing.assert_array_equal(local[v], np.asarray(bins.gidx)[v])
    # every tile of the grid is hit, the overhanging ones too
    assert (counts > 0).all()


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_rasterize_matches_jax_off_the_square(impl):
    args = _rect_scene()
    rgb_j, a_j, info_j = jr.rasterize(*_j(args), impl=impl, **RECT)
    rgb_t, a_t, info_t = tr.rasterize(*_t(args), **RECT)
    assert tuple(rgb_t.shape) == (2, 24, 40, 3) == rgb_j.shape
    assert tuple(a_t.shape) == (2, 24, 40, 1) == a_j.shape
    tol = 1e-5 if impl == "ref" else 1e-4
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=tol,
                               rtol=tol)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=tol,
                               rtol=tol)
    for key in ("tile_overflow", "n_tiles_clipped"):
        np.testing.assert_array_equal(info_t[key].numpy(),
                                      np.asarray(info_j[key]))


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_rasterize_gradients_match_jax_off_the_square(impl):
    args = _rect_scene()
    want, tgt = _jax_grads(args, impl, RECT, "mse")
    got, _, _ = _port_grads(args, RECT, "mse", tgt)
    for name, g, w in zip(NAMES, got, want):
        _assert_scaled(g, w, name)


def test_match_pair_identical_to_jax_off_the_square():
    sub = 8
    preds = _predictions(h=H, w=W)
    jg = jmatch.subsample_grid_indices(H, W, sub)
    tg = tmatch.subsample_grid_indices(H, W, sub)
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    grid = np.asarray(jg[0])
    assert grid.shape == ((H // sub) * (W // sub),)
    for p in preds:
        d1 = p["desc1"].reshape(-1, 8)[grid]
        d2 = p["desc2"].reshape(-1, 8)[grid]
        sim = d1.astype(np.float64) @ d2.T
        assert min(_min_gap(sim, 1), _min_gap(sim, 0)) > MIN_GAP
        jm = jmatch.match_pair(*(jnp.asarray(p[f]) for f in
                                 ("desc1", "desc2", "conf1", "conf2")),
                               subsample=sub)
        tm = tmatch.match_pair(*(torch.from_numpy(p[f]) for f in
                                 ("desc1", "desc2", "conf1", "conf2")),
                               subsample=sub)
        np.testing.assert_array_equal(tm.idx1.numpy(), np.asarray(jm.idx1))
        np.testing.assert_array_equal(tm.idx2.numpy(), np.asarray(jm.idx2))
        np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
        assert tm.mask.sum() > 10
        jp1, jp2 = jmatch.refine_matches(jnp.asarray(p["desc1"]),
                                         jnp.asarray(p["desc2"]), jm,
                                         subsample=sub)
        tp1, tp2 = tmatch.refine_matches(torch.from_numpy(p["desc1"]),
                                         torch.from_numpy(p["desc2"]), tm,
                                         subsample=sub)
        np.testing.assert_array_equal(tp1.numpy(), np.asarray(jp1))
        np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))
        # refined pixels stay on the image: x below W, y below H
        for q in (tp1.numpy(), tp2.numpy()):
            assert q.min() >= 0 and q[..., 0].max() < W and \
                q[..., 1].max() < H


# (width, height) of each photo, and the (H, W) load_images gives it at
# size 224 and 512: the longest edge to `size`, each half-extent cropped to
# a multiple of 16
PHOTOS = {"4x3": ((640, 480), {224: (160, 224), 512: (384, 512)}),
          "3x4": ((480, 640), {224: (224, 160), 512: (512, 384)}),
          "16x9": ((640, 360), {224: (96, 224), 512: (288, 512)})}


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    d = tmp_path_factory.mktemp("photos")
    rng = np.random.default_rng(4)
    paths = {}
    for name, ((w, h), _) in PHOTOS.items():
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx * 255 // w, yy * 255 // h,
                        rng.integers(0, 256, size=(h, w))], -1)
        paths[name] = str(d / f"{name}.png")
        Image.fromarray(img.astype(np.uint8)).save(paths[name])
    return paths


@pytest.mark.parametrize("route", ["native", "pil"])
@pytest.mark.parametrize("size", [224, 512])
@pytest.mark.parametrize("photo", sorted(PHOTOS))
def test_load_images_matches_jax_off_the_square(photos, photo, size, route):
    if route == "native" and not native.available():
        pytest.skip("the native route needs g++")
    got = stt.load_images([photos[photo]], size=size, impl=route)
    want = st.load_images([photos[photo]], size=size, impl=route)
    assert len(got) == len(want) == 1
    assert got[0].shape == (3, *PHOTOS[photo][1][size]) == want[0].shape
    assert got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
