"""The port's two-phase global alignment against the JAX package's, fed the
same CondensedData and MST.

The scene is the JAX package's planted-pose sphere scene
(`utils/synthetic.py::synthetic_ga_scene`, anchored endpoints as the
product matcher gives them), with a few pairs marked as failed matches so
the dust3r fallback loss is live. GA at the integration tests' short
schedule (15 + 8 iterations). Outputs agree to 1e-4 (absolute, and
relative for the focal lengths, which are ~1e2 px): both run Adam in
float32, and only the summation order of the gathers' backward differs.

Poses are compared in the MST root camera's frame. The root's own pose is
a gauge freedom: every loss is invariant to a rigid motion of the whole
scene, so its gradient is zero up to float rounding, and Adam's normalised
step turns that rounding into moves of +-lr. Both packages (and the JAX
package on two backends) therefore place the scene under different rigid
motions; everything measured relative to the root agrees.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax

from starst3r_tpu.alignment.ga import run_global_alignment as j_run_ga
from starst3r_tpu.config import GAConfig
from starst3r_tpu.utils.synthetic import synthetic_ga_scene

from starst3r_tpu_torch.alignment.condense import CondensedData
from starst3r_tpu_torch.alignment.ga import run_global_alignment as t_run_ga
from starst3r_tpu_torch.alignment.lm import lm_refine
from starst3r_tpu_torch.alignment.schur import build_tracks, schur_refine
from starst3r_tpu_torch.config import GAConfig as TGAConfig
from starst3r_tpu_torch.io.from_jax import ga_params_from_jax

torch.backends.cuda.matmul.allow_tf32 = False

FAST = dict(niter1=15, niter2=8)


def _scene(n_cams, seed=0):
    data, mst, gt, _ = synthetic_ga_scene(n_cams=n_cams, hw=64, subsample=8,
                                          focal=90.0, anchored=True)
    rng = np.random.default_rng(seed)
    p = data.pair_img1.shape[0]
    ok = np.ones(p, bool)
    ok[rng.choice(p, size=2, replace=False)] = False
    # the fallback target: image i's core points seen from camera j, with
    # noise, so the regression loss has a real residual
    s = data.core_pix.shape[0]
    preds = rng.normal(size=(p, s, 3)).astype(np.float32) * 0.05
    preds[..., 2] += 4.0
    data = data._replace(
        pair_matching_ok=ok, preds21_pts=preds,
        preds21_conf=rng.uniform(1, 2, size=(p, s)).astype(np.float32),
        corr_conf=(data.corr_conf * rng.uniform(1, 3, size=data.corr_conf
                                                .shape)).astype(np.float32))
    return data, mst


def _port_data(data):
    """The port's own CondensedData type, same arrays."""
    return CondensedData(**data._asdict())


def _np(x):
    return np.asarray(jax.device_get(x))


def _in_root_frame(cam2w, root):
    c = np.asarray(cam2w, np.float64)
    return np.linalg.inv(c[root])[None] @ c


def _check(t_res, j_res, root):
    np.testing.assert_allclose(_in_root_frame(t_res.cam2w.numpy(), root),
                               _in_root_frame(_np(j_res.cam2w), root),
                               atol=1e-4, err_msg="cam2w")
    np.testing.assert_allclose(t_res.K.numpy(), _np(j_res.K), atol=1e-4,
                               rtol=1e-4, err_msg="K")
    np.testing.assert_allclose(t_res.depth.numpy(), _np(j_res.depth),
                               atol=1e-4, err_msg="depth")
    np.testing.assert_allclose(t_res.loss_coarse, j_res.loss_coarse,
                               rtol=1e-4)
    np.testing.assert_allclose(t_res.loss_fine, j_res.loss_fine, rtol=1e-4)


VARIANTS = {
    "default": {},
    "opt_depth_shared_intrinsics": dict(opt_depth=True,
                                        shared_intrinsics=True),
    "exp_depth_mul": dict(exp_depth=True, depth_mode="mul", opt_depth=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_global_alignment_matches_jax(variant):
    data, mst = _scene(4)
    kw = dict(FAST, **VARIANTS[variant])
    j_res, _ = j_run_ga(data, mst, GAConfig(**kw))
    t_res, _ = t_run_ga(_port_data(data), mst, TGAConfig(**kw),
                        device="cpu")
    _check(t_res, j_res, mst[0])


def test_warm_start_and_freeze_match_jax():
    """The incremental path: a 3-camera run's params warm-start a
    4-camera run (prefix overwrite), with an interior camera of the MST
    chain frozen."""
    data3, mst3 = _scene(3, seed=1)
    data4, mst4 = _scene(4, seed=2)
    cfg = dict(FAST)
    _, j_prev = j_run_ga(data3, mst3, GAConfig(**cfg))
    freeze = np.array([False, True, False, False])
    j_res, _ = j_run_ga(data4, mst4, GAConfig(**cfg), prev_params=j_prev,
                        freeze=freeze)
    prev = ga_params_from_jax([np.array(x) for x in j_prev], device="cpu")
    t_res, t_params = t_run_ga(_port_data(data4), mst4, TGAConfig(**cfg),
                               prev_params=prev, freeze=freeze,
                               device="cpu")
    _check(t_res, j_res, mst4[0])
    assert t_params.quats.shape == (4, 4)


def test_unported_options_raise():
    """lora_depth and refine_lm are ported (tests/test_torch_lm.py,
    tests/test_torch_polish.py), and so is the polish's ``mesh``
    (correspondences or tracks sharded over the ranks of a process group,
    tests/test_torch_parallel.py): nothing raises for being unported any
    more. Over a mesh of one rank the polish gives the meshless result,
    and a mesh that is no DeviceMesh is refused."""
    import torch.distributed as dist
    from starst3r_tpu_torch.parallel import initialize_distributed, local_mesh
    data, mst = _scene(3)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    f = np.full(3, 90.0, np.float32)
    pps = np.full((3, 2), 32.0, np.float32)
    depth = np.ones((3, data.core_pix.shape[0]), np.float32)
    tracks = build_tracks(data.corr_img1, data.corr_idx1, data.corr_img2,
                          data.corr_idx2, data.corr_conf, 3,
                          data.core_pix.shape[0])
    corr = (data.corr_img1, data.corr_idx1, data.corr_img2, data.corr_idx2,
            data.corr_conf)
    initialize_distributed(device="cpu")
    try:
        mesh = local_mesh()
        for run in (lambda **kw: lm_refine(c2w, f, pps, depth,
                                           data.core_pix, *corr, iters=3,
                                           device="cpu", **kw),
                    lambda **kw: schur_refine(c2w, f, pps, depth,
                                              data.core_pix, tracks,
                                              iters=3, device="cpu", **kw)):
            want = run()
            got = run(mesh=mesh)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            with pytest.raises(AttributeError):
                run(mesh=object())
    finally:
        dist.destroy_process_group()