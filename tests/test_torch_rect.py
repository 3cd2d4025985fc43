"""The port's reconstruct-and-render slice against the JAX package off the
square, at (H, W) = (64, 96): 4 x 6 patches, an 8 x 12 anchor grid, where a
swap of H and W (of x and y, of cx and cy) hides in a square test.

tests/test_torch_slice.py's recipe and tolerances: the tiny model with the
same weights, `Scene.add_images` twice with the JAX scene's warm start
carried across, `init_3dgs`, `render_3dgs_original(W, H)` and a novel view.
Poses within 1e-3 in camera 0's frame, intrinsics within 1e-3 relative,
equal dense-point counts per camera, and each camera's principal point
nearer (W / 2, H / 2) than (H / 2, W / 2). Renders within
`test_renders_match_jax`'s bounds, each package's renderer on the same
splats and cameras (each reconstruction's). The dense points within 1e-3
plus 1e-3 of each coordinate's magnitude (a new case's bound, stated
relative): the
random network puts some points very far away, where the depth ratio of a
pixel to its anchor cell divides by a depth near 0, and there the two
packages' float32 part by a fraction of 1e-3 of the point (on the square
too, on other images).

The weights are the port's tiny model from seed 0 (the seed
chip_smoke.py's model takes), carried to the JAX package by its own .pth
converter (`convert_state_dict`, the inverse of `io/from_jax.py`,
tests/test_torch_model.py), so no JAX model is initialised. The images are
tests/test_torch_slice.py's, seed 7.

A float32 comparison needs a scene where the reference is stable under
float32 noise, and random weights do not always give one: on other images
(seed 9's at this size) the second call's fine phase has a point of the
reprojection loss near a camera's plane, and the JAX GA rerun from its own
inputs moved by 1e-7 lands outside the poses' bound from itself (ROADMAP
queue 3).
So the slice checks the precondition it needs on seed 7's scene
(`test_reference_is_well_conditioned_here`): the JAX GA's second call,
with the warm start's translations scaled by 1 + 1e-7, within CONDITIONED
of itself, and the JAX render, with the means so scaled, within
`test_renders_match_jax`'s bounds of itself. Beside the two reconstructions' renders, the port's renderer takes
the JAX scene's own splats and cameras (the same float32 inputs).

The network at 64 x 96 and 96 x 64: `infer_pair_batch` against JAX on the
same weights, every output within REL_TOL of its largest magnitude. The
square cases' absolute bounds (tests/test_torch_model.py) do not carry
over: a random network's points are larger off the square, and the two
packages' float32 differ by a few 1e-6 of the largest.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax.numpy as jnp

import starst3r_tpu as st
import starst3r_tpu.reconstruct as jreconstruct
from starst3r_tpu.io.torch_convert import convert_state_dict
from starst3r_tpu.ops.rope import rope_2d_freqs
from starst3r_tpu.splat import render as jrender

import starst3r_tpu_torch as stt

from test_torch_slice import (_cfg, _close, _in_cam0, _port_in_jax_frame,
                              build_scenes, check_first_add_images,
                              check_own_renders,
                              check_poses_and_dense_points)
from torch_slice_inputs import recorded_calls

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, W = 64, 96
# the dense points' relative term (module docstring)
PTS_RTOL = 1e-3
# the precondition: how far the JAX GA may move from itself in camera 0's
# frame when its warm start moves by 1e-7 relative, ten times below the
# poses' 1e-3
CONDITIONED = 1e-4
# the network's outputs: |port - JAX| <= REL_TOL * max|JAX| per output
REL_TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model): the port's tiny model from seed 0 and the
    JAX model on its weights."""
    cfg = st.ModelConfig.tiny()
    tmodel = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(), seed=0,
                                         device="cpu")
    params, unmapped = convert_state_dict(
        {k: v.numpy() for k, v in tmodel.state_dict().items()},
        cfg.enc_depth, cfg.dec_depth, cfg.patch_size, cfg.desc_dim)
    assert unmapped == []
    # the JAX package caches rope's inverse frequencies; made first inside
    # a jit trace the entry is a tracer (ROADMAP queue 3), so a model not
    # built by init_random makes them eagerly first
    for hd in (cfg.enc_dim // cfg.enc_heads, cfg.dec_dim // cfg.dec_heads):
        rope_2d_freqs(jnp.zeros((1, 2)), hd, cfg.rope_base)
    return st.Mast3rModel(cfg, params), tmodel


def _spread(call):
    """The largest move of a pose in camera 0's frame between the JAX GA
    on a call's inputs and the same call with the warm start's
    translations scaled by 1 + 1e-7."""
    args, kw, _ = call
    prev = kw["prev_params"]
    moved = prev._replace(trans=prev.trans * np.float32(1 + 1e-7))
    a, _ = jreconstruct.run_global_alignment(*args, **kw)
    b, _ = jreconstruct.run_global_alignment(
        *args, **dict(kw, prev_params=moved))
    return float(np.abs(_in_cam0(np.asarray(a.cam2w))
                        - _in_cam0(np.asarray(b.cam2w))).max())


def _render_jax(scene, scale=1.0):
    """The JAX render of a JAX scene's splats from its cameras, the means
    scaled by ``scale``."""
    params = {k: jnp.asarray(v) for k, v in scene.gs_state.params.items()}
    params["means"] = params["means"] * np.float32(scale)
    return jrender(params, jnp.asarray(np.asarray(scene.w2c, np.float32)),
                   jnp.asarray(scene.intrinsics), W, H, scene.config.splat,
                   n_alive=scene.gs_state.n_alive)


@pytest.fixture(scope="module")
def built(tmp_path_factory, models):
    with recorded_calls(jreconstruct) as calls:
        scenes = build_scenes(tmp_path_factory, H, W, models=models)
    assert len(calls) == 2
    return scenes, calls[1]


@pytest.fixture(scope="module")
def scenes(built):
    return built[0]


def test_reference_is_well_conditioned_here(built):
    (js, _, _), call = built
    assert _spread(call) <= CONDITIONED
    _close(_render_jax(js, 1 + 1e-7)[0], _render_jax(js)[0])


def test_first_add_images_matches_jax(scenes):
    check_first_add_images(scenes)


def test_poses_dense_points_and_principal_points_match_jax(scenes):
    check_poses_and_dense_points(scenes, pts_rtol=PTS_RTOL)
    js, ts, _ = scenes
    for k in (ts.intrinsics, np.asarray(js.intrinsics)):
        pp = k[:, :2, 2]
        assert (np.linalg.norm(pp - [W / 2, H / 2], axis=-1)
                < np.linalg.norm(pp - [H / 2, W / 2], axis=-1)).all(), pp
    assert [v.conf.shape for v in ts.reconstruction.views] == [(H, W)] * 3


def _both_renders(splats, c2w, K, n_alive, cfg):
    """The JAX and the port's renders of the same float32 splats and
    cameras: (JAX rgb, alpha), (port rgb, alpha)."""
    w2c = np.linalg.inv(np.asarray(c2w, np.float64)).astype(np.float32)
    K = np.asarray(K, np.float32)
    rgb_j, a_j, _ = jrender({k: jnp.asarray(v) for k, v in splats.items()},
                            jnp.asarray(w2c), jnp.asarray(K), W, H, cfg,
                            n_alive=n_alive)
    rgb_t, a_t, _ = stt.gs.render(
        {k: torch.from_numpy(np.array(v)) for k, v in splats.items()},
        w2c, K, W, H, cfg, n_alive=n_alive)
    return (np.asarray(rgb_j), np.asarray(a_j)), (rgb_t.numpy(),
                                                  a_t.numpy())


@pytest.mark.parametrize("which", ["port_scene", "jax_scene"])
def test_renders_match_jax(scenes, which):
    """Each reconstruction's splats rendered by both packages from its
    cameras and from the novel view halfway from camera 0 to camera 2, the
    port's scene in the JAX scene's world frame: `test_renders_match_jax`'s
    bounds. The two reconstructions' renders are not held to each other at
    those bounds here: their poses and points part within the bounds above,
    and the JAX renderer alone turns that into up to 0.05 on a few pixels
    of this scene (on 0.6% of the values beyond 1e-3)."""
    js, ts, _ = scenes
    if which == "port_scene":
        params, c2w = _port_in_jax_frame(js, ts)
        splats = {k: v.numpy() for k, v in params.items()}
        K, n_alive = ts.intrinsics, ts.gs_state.n_alive
    else:
        splats = {k: np.asarray(v) for k, v in js.gs_state.params.items()}
        c2w, K, n_alive = js.c2w, js.intrinsics, int(js.gs_state.n_alive)
    c2w = np.asarray(c2w, np.float32)
    mid = np.asarray(st.interp_se3_path(c2w[0], c2w[2], 3))[1]
    for cams, Ks in ((c2w, K), (mid[None], np.asarray(K)[:1])):
        (rgb_j, a_j), (rgb_t, a_t) = _both_renders(
            splats, cams, Ks, n_alive, ts.config.splat)
        assert rgb_t.shape == rgb_j.shape == (len(cams), H, W, 3)
        _close(rgb_t, rgb_j)
        _close(a_t, a_j)


def test_port_scene_renders_on_its_own_cameras(scenes):
    check_own_renders(scenes, H, W)


@pytest.mark.parametrize("hw", [(64, 96), (96, 64)], ids=["64x96", "96x64"])
def test_pair_outputs_match_jax(models, hw):
    jmodel, tmodel = models
    rng = np.random.default_rng(11)
    img1 = rng.uniform(-1, 1, size=(2, *hw, 3)).astype(np.float32)
    img2 = rng.uniform(-1, 1, size=(2, *hw, 3)).astype(np.float32)
    want = jmodel.infer_pair_batch(jnp.asarray(img1), jnp.asarray(img2))
    got = tmodel.infer_pair_batch(torch.from_numpy(img1),
                                  torch.from_numpy(img2))
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert tuple(got[key].shape) == w.shape, key
        assert w.shape[1:3] == hw, key
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=REL_TOL * scale, err_msg=key)


def test_odd_patch_count_raises_in_both(models):
    """48 x 80 is 3 x 5 patches: the DPT head's skip add of an upsampled
    odd grid fails in both packages (a limit of the reference, ROADMAP
    queue 3). `load_images` never gives such a size: it crops each
    half-extent to a multiple of 16."""
    jmodel, tmodel = models
    img = np.zeros((1, 48, 80, 3), np.float32)
    with pytest.raises(Exception):
        jmodel.infer_pair_batch(jnp.asarray(img), jnp.asarray(img))
    with pytest.raises(RuntimeError, match="must match the size"):
        tmodel.infer_pair_batch(torch.from_numpy(img), torch.from_numpy(img))
