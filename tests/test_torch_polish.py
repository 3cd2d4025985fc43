"""The port's reconstruction options as a whole against the JAX package.

On the tiny model (weights carried across by `io/from_jax.py`) at 64 px
with tests/test_torch_slice.py's images, GA at 15 + 8 iterations:
  - `reconstruct_scene` with `lora_depth` (opt_depth, k = 16 on the 8 x 8
    core grid) and with `refine_lm` ("lm"), against JAX: poses within 1e-3
    in camera 0's frame, intrinsics and core depth within 1e-3 relative
    (tests/test_torch_slice.py's tolerances). The random network's matches
    fail the matching-confidence test, so the "lm" polish gets zero
    weights here and the comparison checks its wiring;
  - `refine_lm` ("schur") on the JAX integration test's noise images, the
    port alone, with that test's checks (finite orthonormal poses, a cost
    that does not rise): on the smooth images no correspondence is
    weighted, and the JAX package's `schur_refine` raises IndexError on an
    empty track set (its `tracks_w.reshape(-1)[0]`), where the port
    returns the GA's poses.

tests/test_torch_polish_branch.py holds the polish branch itself against
the JAX package's on a planted scene.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax

import starst3r_tpu as st
from starst3r_tpu.utils.metrics import MetricsLogger as JLogger

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.io.from_jax import mast3r_state_dict_from_jax
from starst3r_tpu_torch.utils.metrics import MetricsLogger as TLogger

from test_torch_slice import H, W, _images, _in_cam0

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

VARIANTS = {
    "lm": dict(refine_lm=True, lm_mode="lm"),
    "lora": dict(opt_depth=True, lora_depth=True, lora_k=16),
}


def _cfg(pkg, **ga):
    cfg = pkg.default_config()
    return dataclasses.replace(
        cfg, ga=dataclasses.replace(cfg.ga, niter1=15, niter2=8, **ga))


@pytest.fixture(scope="module")
def models():
    jmodel = st.Mast3rModel.init_random(st.ModelConfig.tiny(), seed=1,
                                        image_hw=(H, W))
    tmodel = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(),
                                         device="cpu")
    tmodel.load_state_dict(mast3r_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jmodel.params)))
    return jmodel, tmodel


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """One pair cache per package, shared by the tests."""
    return (str(tmp_path_factory.mktemp("jax")),
            str(tmp_path_factory.mktemp("port")))


def _lm_record(logger):
    (rec,) = [r for r in logger.records if r["event"] == "lm_refine"]
    return rec


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reconstruct_options_match_jax(models, caches, variant):
    jmodel, tmodel = models
    imgs = _images(3)
    ga = VARIANTS[variant]
    jlog, tlog = JLogger(), TLogger()
    jrec, _ = st.reconstruct_scene(jmodel, imgs, tmpdir=caches[0],
                                   config=_cfg(st, **ga), logger=jlog)
    trec, tparams = stt.reconstruct_scene(
        tmodel, imgs, device="cpu", tmpdir=caches[1],
        config=_cfg(stt, **ga), logger=tlog)
    assert trec.cam2w.shape == (3, 4, 4)
    np.testing.assert_allclose(_in_cam0(trec.cam2w), _in_cam0(jrec.cam2w),
                               atol=1e-3)
    np.testing.assert_allclose(trec.intrinsics, jrec.intrinsics, rtol=1e-3)
    np.testing.assert_allclose(trec.core_depth, np.asarray(jrec.core_depth),
                               rtol=1e-3)
    if variant == "lora":
        assert tuple(tparams.core_depth.shape) == (3, 16)
    else:
        trec_lm, jrec_lm = _lm_record(tlog), _lm_record(jlog)
        assert trec_lm["iters"] == jrec_lm["iters"] == 12
        for key in ("cost_first", "cost_last"):
            np.testing.assert_allclose(trec_lm[key], jrec_lm[key],
                                       rtol=1e-3, atol=1e-9)


def test_reconstruct_with_schur_refine(models, caches):
    """tests/test_integration.py::test_reconstruct_with_lm_refine's checks
    and images (uniform noise), lm_iters 4. As there, the intrinsics are
    not checked: on the random network's scene the polish drives one
    camera's focal to inf in both packages (the cost falls as the focal
    grows and every ray collapses onto the optical axis)."""
    _, tmodel = models
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1, 1, size=(3, H, W)).astype(np.float32)
            for _ in range(3)]
    logger = TLogger()
    rec, _ = stt.reconstruct_scene(
        tmodel, imgs, device="cpu", tmpdir=caches[1], logger=logger,
        config=_cfg(stt, refine_lm=True, lm_iters=4, lm_mode="schur"))
    assert np.all(np.isfinite(rec.cam2w))
    R = rec.cam2w[:, :3, :3]
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", R, R),
                               np.tile(np.eye(3), (3, 1, 1)), atol=1e-3)
    lm = _lm_record(logger)
    assert lm["iters"] == 4 and lm["cost_first"] > 0
    assert lm["cost_last"] <= lm["cost_first"] + 1e-6
