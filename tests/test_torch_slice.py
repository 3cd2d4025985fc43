"""The port's reconstruct-and-render slice as a whole against the JAX
package: `Scene.add_images` twice (warm start and pair cache) ->
`init_3dgs` -> `render_3dgs_original` and a `render_3dgs` novel view, with
the same network weights (carried over by `io/from_jax.py`) and the same
numpy images, tiny model at 64 px, GA at 15 + 8 iterations.

Stated tolerances: equal dense-point counts per camera; cam2w and dense
points within 1e-3, intrinsics within 1e-3 relative; rendered rgb and
alpha within 1e-3 for 99% of the values and within 1e-2 for all (the
reason is in `test_renders_match_jax`). Poses and points are compared in
camera 0's frame: the
global alignment leaves the whole scene's rigid motion free (its gradient
is float rounding, which Adam's normalised step turns into moves of +-lr,
see tests/test_torch_ga.py), and renders do not depend on it.

That free motion also lands in the GA parameters the first `add_images`
hands to the second as its warm start, where the new MST may chain the
cameras differently and make it a real relative pose. So before the second
call the port's scene takes the JAX scene's warm-start parameters through
`io.from_jax.ga_params_from_jax`: both second calls then start from the
same numbers.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax

import starst3r_tpu as st

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.io.from_jax import (ga_params_from_jax,
                                            mast3r_state_dict_from_jax)

from torch_slice_inputs import close_renders as _close
from torch_slice_inputs import smooth_images as _images

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H = W = 64


def _cfg(pkg):
    cfg = pkg.default_config()
    return dataclasses.replace(
        cfg, ga=dataclasses.replace(cfg.ga, niter1=15, niter2=8))


def _in_cam0(c2w, pts=None):
    c2w = np.asarray(c2w, np.float64)
    inv = np.linalg.inv(c2w[0])
    if pts is None:
        return inv[None] @ c2w
    return pts @ inv[:3, :3].T + inv[:3, 3]


def build_scenes(tmp_path_factory, h, w, seed=7, models=None):
    """The JAX and the port's scenes after two `add_images` calls and
    `init_3dgs` on three (3, h, w) images, and the first call's poses in
    camera 0's frame and dense-point counts per camera, of each.
    ``models``: (JAX model, port model) with the same weights; by default
    the JAX tiny model from seed 1, carried over to the port."""
    imgs = _images(3, seed=seed, h=h, w=w)
    if models is None:
        jmodel = st.Mast3rModel.init_random(st.ModelConfig.tiny(), seed=1,
                                            image_hw=(h, w))
        tmodel = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(),
                                             device="cpu")
        tmodel.load_state_dict(mast3r_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, jmodel.params)))
    else:
        jmodel, tmodel = models
    js = st.Scene(cache_dir=str(tmp_path_factory.mktemp("jax")),
                  config=_cfg(st))
    ts = stt.Scene(cache_dir=str(tmp_path_factory.mktemp("port")),
                   config=_cfg(stt), device="cpu")
    first = []
    for scene, model in ((js, jmodel), (ts, tmodel)):
        scene.add_images(model, imgs[:2])
        first.append((_in_cam0(scene.c2w), [len(p) for p in
                                            scene.dense_pts]))
    ts.optim_params = ga_params_from_jax(
        [np.array(x) for x in js.optim_params], device="cpu")
    for scene, model in ((js, jmodel), (ts, tmodel)):
        scene.add_images(model, imgs[2:])
        scene.init_3dgs()
    return js, ts, first


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return build_scenes(tmp_path_factory, H, W)


def check_first_add_images(scenes):
    _, _, ((jc, jn), (tc, tn)) = scenes
    assert tc.shape == (2, 4, 4)
    np.testing.assert_allclose(tc, jc, atol=1e-3)
    assert tn == jn


def test_first_add_images_matches_jax(scenes):
    check_first_add_images(scenes)


def check_poses_and_dense_points(scenes, pts_rtol=0.0):
    """Poses within 1e-3 in camera 0's frame, intrinsics within 1e-3
    relative, equal dense-point counts, the points within 1e-3 (plus
    ``pts_rtol`` of each coordinate's magnitude) in camera 0's frame."""
    js, ts, _ = scenes
    assert ts.c2w.shape == js.c2w.shape == (3, 4, 4)
    np.testing.assert_allclose(_in_cam0(ts.c2w), _in_cam0(js.c2w),
                               atol=1e-3)
    np.testing.assert_allclose(ts.intrinsics, js.intrinsics, rtol=1e-3)
    assert [len(p) for p in ts.dense_pts] == [len(p) for p in js.dense_pts]
    assert sum(len(p) for p in ts.dense_pts) > 1000
    np.testing.assert_allclose(_in_cam0(ts.c2w, ts.dense_pts_flat),
                               _in_cam0(js.c2w, js.dense_pts_flat),
                               atol=1e-3, rtol=pts_rtol)
    np.testing.assert_allclose(ts.dense_cols_flat, js.dense_cols_flat,
                               atol=1e-6)
    assert ts.gs_state.n_alive == int(js.gs_state.n_alive)


def test_poses_and_dense_points_match_jax(scenes):
    check_poses_and_dense_points(scenes)


def _port_in_jax_frame(js, ts):
    """The port's Gaussians and cameras moved by the rigid motion that
    takes its camera 0 onto the JAX scene's camera 0."""
    G = (np.asarray(js.c2w[0], np.float64)
         @ np.linalg.inv(np.asarray(ts.c2w[0], np.float64)))
    params = dict(ts.gs_state.params)
    m = params["means"].double().numpy()
    params["means"] = torch.from_numpy(
        (m @ G[:3, :3].T + G[:3, 3]).astype(np.float32))
    c2w = (G[None] @ np.asarray(ts.c2w, np.float64)).astype(np.float32)
    return params, c2w


def check_renders(scenes, h, w):
    """Renders are compared in the JAX scene's world frame: the SH band-1
    colours are defined on world axes, so the scene's free rigid motion
    changes view-dependent colour. Bound: see `_close`. The reconstructions
    agree to ~1e-4 world units in point position (float32 differences of
    the two networks carried through the alignment), and the initial
    splats are a fraction of a pixel wide, so a pixel's alpha moves by up
    to ~1.5 per pixel of displacement of the splat over it."""
    js, ts, _ = scenes
    cfg = ts.config.splat
    params, c2w = _port_in_jax_frame(js, ts)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    rgb_j, a_j, info_j = js.render_3dgs_original(w, h)
    rgb_t, a_t, info_t = stt.gs.render(params, w2c, ts.intrinsics, w, h, cfg,
                                       n_alive=ts.gs_state.n_alive)
    assert rgb_t.shape == (3, h, w, 3) and a_t.shape == (3, h, w, 1)
    _close(rgb_t.numpy(), rgb_j)
    _close(a_t.numpy(), a_j)
    np.testing.assert_allclose(info_t["tile_overflow"].numpy(),
                               np.asarray(info_j["tile_overflow"]), rtol=1e-3)
    # a novel view halfway along the path from camera 0 to camera 2
    path = np.asarray(st.interp_se3_path(js.c2w[0], js.c2w[2], 3))
    np.testing.assert_allclose(
        stt.interp_se3_path(c2w[0], c2w[2], 3).numpy(), path, atol=1e-3)
    w2c_mid = np.linalg.inv(path[1]).astype(np.float32)
    rgb_jn, _, _ = js.render_3dgs(w2c_mid, js.intrinsics[0], w, h)
    rgb_tn, _, _ = stt.gs.render(params, w2c_mid[None],
                                 ts.intrinsics[:1], w, h, cfg,
                                 n_alive=ts.gs_state.n_alive)
    _close(rgb_tn.numpy(), rgb_jn)


def test_renders_match_jax(scenes):
    check_renders(scenes, H, W)


def check_own_renders(scenes, h, w):
    """The port's own entry points: render_3dgs_original and a novel
    render_3dgs, finite, shaped, and with the JAX scene's coverage."""
    js, ts, _ = scenes
    rgb, alpha, info = ts.render_3dgs_original(w, h)
    assert rgb.shape == (3, h, w, 3) and torch.isfinite(rgb).all()
    path = stt.interp_se3_path(ts.c2w[0], ts.c2w[2], 4)
    w2c = torch.linalg.inv(path)
    rgb_n, alpha_n, _ = ts.render_3dgs(
        w2c, np.repeat(ts.intrinsics[:1], 4, 0), w, h)
    assert rgb_n.shape == (4, h, w, 3) and torch.isfinite(rgb_n).all()
    _, a_j, _ = js.render_3dgs_original(w, h)
    np.testing.assert_allclose(alpha.mean().item(),
                               float(np.asarray(a_j).mean()), atol=1e-3)


def test_port_scene_renders_on_its_own_cameras(scenes):
    check_own_renders(scenes, H, W)
