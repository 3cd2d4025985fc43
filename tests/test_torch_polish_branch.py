"""The polish branch of `reconstruct_scene` (`reconstruct._refine_lm`: the
matching and freeze masks on the correspondence weights, the tracks, the
focals written back into K) against the JAX package's branch
(`starst3r_tpu/reconstruct.py:264-303`, written out below), both fed the
JAX GA's output on the planted sphere scene
(`utils/synthetic.py::synthetic_ga_scene`, 4 cameras, 64 px; a 15 + 8
iteration GA, so the polish has work), in both modes, with and without
frozen cameras.

Stated tolerances, tests/test_torch_lm.py's (the JAX tests' own for two
reductions of one system): the cost after each iteration within rtol 1e-3
/ atol 1e-9 ("lm") or rtol 2e-2 / atol 1e-8 ("schur"), poses within 1e-3,
K within 1e-3 relative.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

from starst3r_tpu.alignment import lm as jlm
from starst3r_tpu.alignment import schur as jschur
from starst3r_tpu.alignment.ga import run_global_alignment as j_run_ga
from starst3r_tpu.config import GAConfig
from starst3r_tpu.utils.synthetic import synthetic_ga_scene

from starst3r_tpu_torch.alignment.condense import CondensedData
from starst3r_tpu_torch.config import GAConfig as TGAConfig
from starst3r_tpu_torch.reconstruct import _refine_lm

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def planted():
    data, mst, _, _ = synthetic_ga_scene(n_cams=4, hw=64, subsample=8,
                                         focal=90.0, anchored=True)
    res, _ = j_run_ga(data, mst, GAConfig(niter1=15, niter2=8))
    return (data, np.asarray(res.cam2w), np.asarray(res.K),
            np.asarray(res.depth))


def _jax_polish(ga, data, freeze, cam2w, K, depth, n):
    """starst3r_tpu/reconstruct.py:264-303, the JAX package's branch."""
    conf = (np.asarray(data.corr_conf)
            * np.asarray(data.pair_matching_ok)[np.asarray(data.corr_pair)])
    if freeze is not None:
        conf = conf * ~(freeze[data.corr_img1] & freeze[data.corr_img2])
    conf = conf.astype(np.float32)
    if ga.lm_mode == "schur":
        tracks = jschur.build_tracks(
            data.corr_img1, data.corr_idx1, data.corr_img2, data.corr_idx2,
            conf, n, data.core_pix.shape[0], max_obs=ga.lm_max_obs)
        out = jschur.schur_refine(cam2w, K[:, 0, 0], K[:, :2, 2], depth,
                                  data.core_pix, tracks, iters=ga.lm_iters,
                                  damping=ga.lm_damping)
    else:
        out = jlm.lm_refine(cam2w, K[:, 0, 0], K[:, :2, 2], depth,
                            data.core_pix, data.corr_img1, data.corr_idx1,
                            data.corr_img2, data.corr_idx2, conf,
                            iters=ga.lm_iters, damping=ga.lm_damping)
    cam2w, focals, costs = out
    K = K.copy()
    K[:, 0, 0] = focals
    K[:, 1, 1] = focals
    return cam2w, K, costs


@pytest.mark.parametrize("mode", ["lm", "schur"])
@pytest.mark.parametrize("frozen", [False, True])
def test_polish_branch_matches_jax_on_planted_scene(planted, mode, frozen):
    data, cam2w, K, depth = planted
    freeze = np.array([True, True, False, False]) if frozen else None
    ga = dict(refine_lm=True, lm_mode=mode, lm_iters=6)
    jc2w, jK, jcosts = _jax_polish(GAConfig(**ga), data, freeze, cam2w, K,
                                   depth, 4)
    tc2w, tK, tcosts = _refine_lm(TGAConfig(**ga),
                                  CondensedData(**data._asdict()), freeze,
                                  cam2w, K, depth, 4, torch.device("cpu"))
    assert len(tcosts) == 6 and tcosts[-1] < tcosts[0]
    rtol, atol = (2e-2, 1e-8) if mode == "schur" else (1e-3, 1e-9)
    np.testing.assert_allclose(tcosts, jcosts, rtol=rtol, atol=atol)
    np.testing.assert_allclose(tc2w, jc2w, atol=1e-3)
    np.testing.assert_allclose(tK, jK, rtol=1e-3)
