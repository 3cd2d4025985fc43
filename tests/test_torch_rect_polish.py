"""Spectral low-rank depth (`lora_depth`) and the LM polish off the square,
against the JAX package: at 64 x 96 the spectral basis's core grid is
8 x 12 (`grid_hw = (hs, ws)`, hs != ws), where a swap of the two hides in
a square test.

  - `spectral_projection_of_depthmaps` on 8 x 12 and 12 x 8 grids: the
    coefficients and the basis equal to JAX's bit for bit (both host
    numpy and scipy, as tests/test_torch_lm.py holds them on square
    grids);
  - the lora GA's coarse phase on the JAX reconstruction's own inputs (its
    condensed data, MST, spectral basis and coefficients, recorded from
    `reconstruct_scene` at 64 x 96): poses within 1e-3 in camera 0's frame
    and the coefficients within 1e-3 relative, tests/test_torch_polish.py's
    tolerances;
  - `reconstruct_scene` with `lora_depth` (k = 16) and `refine_lm` ("lm")
    at 64 x 96 in the port: the integration test's checks (finite
    orthonormal poses, (3, 16) coefficients, 12 LM iterations, a cost that
    does not rise).

The whole reconstruction is not held to JAX's here: with `lora_depth` on
these scenes the JAX package itself moves far beyond 1e-3 in camera 0's
frame when its images are scaled by 1 + 1e-6, so two float32 programs
part there by as much. The fine phase is where it happens (see
tests/test_torch_rect.py), so the GA is held on its coarse phase.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import starst3r_tpu as st
import starst3r_tpu.reconstruct as jreconstruct
from starst3r_tpu.alignment import spectral as jspectral

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.alignment import ga as tga
from starst3r_tpu_torch.alignment import spectral as tspectral
from starst3r_tpu_torch.alignment.condense import CondensedData
from starst3r_tpu_torch.utils.metrics import MetricsLogger as TLogger

from test_torch_polish import _lm_record
from test_torch_rect import H, W, models  # noqa: F401
from test_torch_slice import _images, _in_cam0
from torch_slice_inputs import recorded_calls

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GA = dict(niter1=15, niter2=8, opt_depth=True, lora_depth=True, lora_k=16,
          refine_lm=True, lm_mode="lm")


def _cfg(pkg, **ga):
    cfg = pkg.default_config()
    return dataclasses.replace(cfg, ga=dataclasses.replace(cfg.ga,
                                                           **dict(GA, **ga)))


@pytest.mark.parametrize("grid_hw", [(8, 12), (12, 8)], ids=["8x12", "12x8"])
def test_spectral_projection_equals_jax_off_the_square(grid_hw):
    rng = np.random.default_rng(0)
    s = grid_hw[0] * grid_hw[1]
    colors = rng.uniform(size=(3, s, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 2.0, size=(3, s)).astype(np.float32)
    want = jspectral.spectral_projection_of_depthmaps(
        colors, depth, grid_hw, k=16, gamma=15.0, min_norm=0.5)
    got = tspectral.spectral_projection_of_depthmaps(
        colors, depth, grid_hw, k=16, gamma=15.0, min_norm=0.5)
    assert got[1].shape == (3, s, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_lora_ga_coarse_phase_matches_jax(models, tmp_path):  # noqa: F811
    jmodel, _ = models
    with recorded_calls(jreconstruct) as calls:
        st.reconstruct_scene(jmodel, _images(3, h=H, w=W),
                             tmpdir=str(tmp_path), config=_cfg(st))
    (data, mst, _), kw, _ = calls[0]
    assert np.asarray(kw["depth_basis"]).shape == (3, (H // 8) * (W // 8), 16)
    jres, jparams = jreconstruct.run_global_alignment(
        data, mst, _cfg(st, niter2=0).ga,
        **dict(kw, prev_params=None))
    tdata = CondensedData(*[None if x is None else np.asarray(x)
                            for x in data])
    tres, tparams = tga.run_global_alignment(
        tdata, mst, _cfg(stt, niter2=0).ga, prev_params=None,
        freeze=kw["freeze"], depth_basis=np.asarray(kw["depth_basis"]),
        depth_coeffs=np.asarray(kw["depth_coeffs"]), device="cpu")
    np.testing.assert_allclose(_in_cam0(tres.cam2w.numpy()),
                               _in_cam0(np.asarray(jres.cam2w)), atol=1e-3)
    np.testing.assert_allclose(tparams.core_depth.numpy(),
                               np.asarray(jparams.core_depth), rtol=1e-3,
                               atol=1e-6)


def test_lora_lm_reconstruction_runs_off_the_square(models,  # noqa: F811
                                                    tmp_path):
    _, tmodel = models
    logger = TLogger()
    rec, params = stt.reconstruct_scene(
        tmodel, _images(3, h=H, w=W), device="cpu", tmpdir=str(tmp_path),
        config=_cfg(stt), logger=logger)
    assert np.all(np.isfinite(rec.cam2w))
    R = rec.cam2w[:, :3, :3]
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", R, R),
                               np.tile(np.eye(3), (3, 1, 1)), atol=1e-3)
    assert tuple(params.core_depth.shape) == (3, 16)
    assert rec.core_depth.shape == (3, (H // 8) * (W // 8))
    lm = _lm_record(logger)
    assert lm["iters"] == 12
    assert lm["cost_last"] <= lm["cost_first"] + 1e-6
