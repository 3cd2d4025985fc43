"""The port's rasterizer forward (projection, tile binning, entry gather,
compositing) and 3DGS init/render against the JAX package.

On the CPU the port composites with its plain torch version
(`splat.composite.composite_tiles_plain`); the scenes are those of
tests/test_pallas_composite.py. Tolerances: 1e-5 against the JAX reference
compositing (`impl="ref"`) and 1e-4 against the JAX Pallas forward, run in
interpret mode as the JAX tests run it (its own tolerance against the
reference is 1e-4).

The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py, which needs an NVIDIA GPU.
"""

import importlib

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from starst3r_tpu.config import SplatConfig
from starst3r_tpu.splat import train as jtrain

from starst3r_tpu_torch.io.from_jax import gaussians_from_jax
from starst3r_tpu_torch.splat import composite as tc
from starst3r_tpu_torch.splat import train as ttrain
from starst3r_tpu_torch.config import SplatConfig as TSplatConfig

# the packages' `splat` namespaces export a function named `rasterize`,
# which shadows the module of that name
jr = importlib.import_module("starst3r_tpu.splat.rasterize")
tr = importlib.import_module("starst3r_tpu_torch.splat.rasterize")

KW = dict(width=32, height=32, sh_degree=1, tile_size=16,
          max_tiles_per_gaussian=9, max_per_tile=128, chunk=32)
KW_MULTI = dict(width=32, height=32, sh_degree=1, tile_size=16,
                max_tiles_per_gaussian=4, max_per_tile=512, chunk=128)


def _scene(seed=0, n=96):
    """tests/test_pallas_composite.py::_scene as numpy."""
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
    return means, quats, scales, opac, sh, w2c, K


def _opaque_wall(seed=0):
    """tests/test_pallas_composite.py::test_pallas_early_exit_opaque_wall."""
    rng = np.random.default_rng(seed)
    n = 64
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = np.linspace(1.0, 5.0, n)
    means[:, :2] = rng.normal(size=(n, 2)) * 0.01
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 2.0, np.float32)
    opac = np.full((n,), 0.999, np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[0, 0] = (np.array([1.0, 0.0, 0.0]) - 0.5) / 0.28209479177387814
    w2c = np.eye(4, dtype=np.float32)[None]
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)[None]
    return means, quats, scales, opac, sh, w2c, K


def _t(args):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)


def _j(args):
    return tuple(jnp.asarray(a) for a in args)


def test_project_gaussians_matches_jax():
    args = _scene()
    pj = [jr.project_gaussians(*_j(args[:5]), jnp.asarray(args[5][c]),
                               jnp.asarray(args[6][c]), 1)
          for c in range(2)]
    pt = tr.project_gaussians(*_t(args), 1)
    for f in ("means2d", "depths", "conics", "radii", "colors", "valid"):
        want = np.stack([np.asarray(getattr(p, f)) for p in pj])
        got = getattr(pt, f).numpy()
        if want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f)


@pytest.mark.parametrize("kw", [KW, KW_MULTI, dict(KW, max_per_tile=16,
                                                   max_tiles_per_gaussian=2)],
                         ids=["scene", "multichunk", "overflow_clipped"])
def test_binning_matches_jax(kw):
    """Same (tile, depth, id) order per tile, same capped counts, same
    overflow and truncation counts."""
    n = 1400 if kw is KW_MULTI else 96
    args = _scene(n=n)
    bins = jr.bin_gaussians(
        *_j(args), width=kw["width"], height=kw["height"], sh_degree=1,
        tile_size=kw["tile_size"],
        max_tiles_per_gaussian=kw["max_tiles_per_gaussian"],
        max_per_tile=kw["max_per_tile"])
    tw = th = -(-kw["width"] // kw["tile_size"])
    proj = tr.project_gaussians(*_t(args), 1)
    gidx, valid, counts, overflow, n_clip, max_count = tr._bin_gaussians(
        proj, tw, th, kw["tile_size"], kw["max_tiles_per_gaussian"],
        kw["max_per_tile"])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(bins.ent_valid))
    np.testing.assert_array_equal(max_count.numpy(),
                                  np.asarray(bins.max_count))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(bins.counts))
    np.testing.assert_array_equal(overflow.numpy(), np.asarray(bins.overflow))
    np.testing.assert_array_equal(n_clip.numpy(), np.asarray(bins.n_clipped))
    local = (gidx - torch.arange(2)[:, None, None] * n).numpy()
    v = np.asarray(bins.ent_valid)
    np.testing.assert_array_equal(local[v], np.asarray(bins.gidx)[v])
    if kw["max_per_tile"] == 16:
        assert overflow.sum() > 0 and n_clip.sum() > 0


@pytest.mark.parametrize("case", ["scene", "opaque_wall"])
def test_rasterize_matches_jax_reference(case):
    args = _scene() if case == "scene" else _opaque_wall()
    rgb_r, a_r, info_r = jr.rasterize(*_j(args), impl="ref", **KW)
    rgb_t, a_t, info_t = tr.rasterize(*_t(args), **KW)
    assert rgb_t.shape == rgb_r.shape and a_t.shape == a_r.shape
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_r), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_r), atol=1e-5,
                               rtol=1e-5)
    for key in ("tile_overflow", "n_tiles_clipped"):
        np.testing.assert_array_equal(info_t[key].numpy(),
                                      np.asarray(info_r[key]))
    np.testing.assert_allclose(info_t["means2d"].numpy(),
                               np.asarray(info_r["means2d"]), rtol=1e-5)
    if case == "opaque_wall":
        assert float(rgb_t[0, 16, 16, 0]) > 0.8


@pytest.mark.parametrize("case", ["scene", "multichunk"])
def test_rasterize_matches_jax_pallas_forward(case):
    """Against `composite_tiles_pallas` (the TPU kernel this port's CUDA
    kernel replaces), run in interpret mode on the CPU."""
    kw = KW if case == "scene" else KW_MULTI
    args = _scene(n=96 if case == "scene" else 1400)
    rgb_p, a_p, _ = jr.rasterize(*_j(args), impl="pallas", **kw)
    rgb_t, a_t, _ = tr.rasterize(*_t(args), **kw)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_p), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_p), atol=1e-4,
                               rtol=1e-4)


def test_composite_plain_matches_jax_composite_tiles():
    """`composite_tiles_plain` (batched over cameras) against the JAX
    reference `_composite_tiles` camera by camera, on random entries whose
    slots past each tile's count are zero."""
    rng = np.random.default_rng(3)
    c, tw, th, tile, k = 2, 3, 2, 8, 48
    t = tw * th
    ent = np.zeros((c, t, k, 9), np.float32)
    counts = rng.integers(0, k + 1, size=(c, t)).astype(np.int32)
    for ci in range(c):
        for ti in range(t):
            m = counts[ci, ti]
            ent[ci, ti, :m, 0] = rng.uniform(0, tw * tile, m)
            ent[ci, ti, :m, 1] = rng.uniform(0, th * tile, m)
            ent[ci, ti, :m, 2] = rng.uniform(0.02, 0.3, m)
            ent[ci, ti, :m, 3] = rng.uniform(-0.01, 0.01, m)
            ent[ci, ti, :m, 4] = rng.uniform(0.02, 0.3, m)
            ent[ci, ti, :m, 5:8] = rng.uniform(0, 1, (m, 3))
            ent[ci, ti, :m, 8] = rng.uniform(0.1, 1.0, m)
    h, w = th * tile - 3, tw * tile - 5          # ragged image edge
    rgb, alpha = tc.composite_tiles_plain(torch.from_numpy(ent),
                                          torch.from_numpy(counts), h, w,
                                          tile, tw, th, chunk=16)
    for ci in range(c):
        e = jnp.asarray(ent[ci])
        rgb_j, a_j = jr._composite_tiles(e[..., 0:2], e[..., 2:5],
                                         e[..., 5:8], e[..., 8], h, w, tile,
                                         tw, th, k, 16)
        np.testing.assert_allclose(rgb[ci].numpy(), np.asarray(rgb_j),
                                   atol=1e-6)
        np.testing.assert_allclose(alpha[ci].numpy(), np.asarray(a_j),
                                   atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    ent = torch.zeros((1, 4, 8, 9))
    counts = torch.zeros((1, 4), dtype=torch.int32)
    before = tc.composite_tiles_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tc.composite_tiles_cuda(ent, counts, 32, 32, 16, 2, 2)
    tc.composite_tiles(ent, counts, 32, 32, 16, 2, 2)
    assert tc.composite_tiles_cuda.launches == before


@pytest.mark.parametrize("compat", [True, False])
def test_init_and_render_match_jax(compat):
    """splat/train.py: init_gaussians (with the inactive pool tail) and
    render (colors = shN, n_alive masking) against the JAX package."""
    rng = np.random.default_rng(8)
    n = 120
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    pts[:, 2] += 2.5
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    scales = rng.uniform(0.01, 0.05, size=n).astype(np.float32)
    kw = dict(compat_inverted_sh=compat, compat_raw_activations=compat,
              max_per_tile=128, max_tiles_per_gaussian=9)
    jcfg, tcfg = SplatConfig(**kw), TSplatConfig(**kw)
    jst = jtrain.init_gaussians(pts, cols, jcfg, pool_size=150,
                                point_scales=scales)
    tst = ttrain.init_gaussians(pts, cols, tcfg, pool_size=150,
                                point_scales=scales, device="cpu")
    jparams = jax.tree_util.tree_map(np.asarray, jst.params)
    for key, val in gaussians_from_jax(jparams, device="cpu").items():
        np.testing.assert_allclose(tst.params[key].numpy(), val.numpy(),
                                   rtol=1e-6, err_msg=key)
    assert tst.n_alive == int(jst.n_alive) == n
    _, _, _, _, _, w2c, K = _scene()
    rgb_j, a_j, _ = jtrain.render(jst.params, w2c, K, 32, 32, jcfg,
                                  n_alive=jst.n_alive)
    rgb_t, a_t, _ = ttrain.render(tst.params, w2c, K, 32, 32, tcfg,
                                  n_alive=tst.n_alive)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-4,
                               rtol=1e-4)
