"""The port's LM / Schur polish and spectral low-rank depth against the JAX
package, on the JAX tests' planted problems.

  - `chain_to_absolute` round trip (tests/test_lm.py's tolerances);
  - `lm_refine` on tests/test_lm.py's exact 6-camera problem and
    `schur_refine` on tests/test_schur.py's 50-keyframe windowed sequence
    (the same instances, drawn from the same seeds):
    the cost after each iteration and the final poses and focals, held with
    the JAX tests' own tolerances for two reductions of one system (costs
    rtol 1e-3 / atol 1e-9 for LM, rtol 2e-2 / atol 1e-8 for Schur, poses
    1e-3). Camera 0 is frozen in both, so both solve in one frame. The
    first iterations are clear improvements, so both packages accept the
    same steps; near convergence the costs are float noise (atol);
  - the Schur-reduced system and the LM normal equations themselves at one
    point, relative to their largest entry: 1e-4 (float32 sums of the same
    products in another order; the Schur correction cancels against the
    diagonal blocks);
  - `build_tracks` and `schur_partition_sizes` equal exactly (same numpy);
  - `lowrank_basis` and `spectral_projection_of_depthmaps` equal bit for
    bit (same numpy and scipy on the same inputs), on the dense and the
    `eigsh` routes;
  - the GA with `lora_depth` on the planted sphere scene, 4 cameras, 64 px,
    15 + 8 iterations: losses, depth, K and poses in the root camera's frame
    within 1e-4, as tests/test_torch_ga.py holds the dense GA.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from starst3r_tpu.alignment import lm as jlm
from starst3r_tpu.alignment import schur as jschur
from starst3r_tpu.alignment import spectral as jspectral
from starst3r_tpu.alignment.ga import run_global_alignment as j_run_ga
from starst3r_tpu.config import GAConfig
from starst3r_tpu.utils.synthetic import synthetic_ga_scene

from starst3r_tpu_torch.alignment import lm as tlm
from starst3r_tpu_torch.alignment import schur as tschur
from starst3r_tpu_torch.alignment import spectral as tspectral
from starst3r_tpu_torch.alignment.condense import CondensedData
from starst3r_tpu_torch.alignment.ga import run_global_alignment as t_run_ga
from starst3r_tpu_torch.config import GAConfig as TGAConfig
from starst3r_tpu_torch.utils.se3 import quat_to_rotmat

from test_lm import _perturb as _perturb_lm
from test_lm import _rotz
from test_lm import synthetic_ba  # noqa: F401  (fixture)
from test_schur import _make_seq
from test_schur import _perturb as _perturb_seq

torch.backends.cuda.matmul.allow_tf32 = False


def test_chain_to_absolute_roundtrip(rng):
    c = 4
    cam2w = np.tile(np.eye(4, dtype=np.float32)[None], (c, 1, 1))
    for i in range(c):
        cam2w[i, :3, :3] = _rotz(0.3 * i)
        cam2w[i, :3, 3] = rng.normal(size=3)
    st = tlm.chain_to_absolute(torch.as_tensor(cam2w),
                               torch.full((c,), 50.0))
    np.testing.assert_allclose(quat_to_rotmat(st.quats).numpy(),
                               cam2w[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(st.trans.numpy(), cam2w[:, :3, 3])
    np.testing.assert_allclose(np.exp(st.log_focals.numpy()), 50.0,
                               rtol=1e-6)
    jst = jlm.chain_to_absolute(jnp.asarray(cam2w), jnp.full((c,), 50.0))
    np.testing.assert_allclose(st.quats.numpy(), np.asarray(jst.quats),
                               atol=1e-6)


def _lm_args(d, cam2w):
    return (cam2w, d["focals"], d["pps"], d["depths"], d["core_pix"],
            d["img1"], d["idx1"], d["img2"], d["idx2"], d["conf"])


@pytest.mark.parametrize("opt_focal", [False, True])
def test_lm_refine_matches_jax(synthetic_ba, rng, opt_focal):  # noqa: F811
    d = synthetic_ba
    noisy = _perturb_lm(d["cam2w"], rng)
    jo, jf, jc = jlm.lm_refine(*_lm_args(d, noisy), iters=12,
                               opt_focal=opt_focal)
    to, tf, tc = tlm.lm_refine(*_lm_args(d, noisy), iters=12,
                               opt_focal=opt_focal, device="cpu")
    assert len(tc) == 12
    np.testing.assert_allclose(tc, jc, rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(to, jo, atol=1e-3)
    np.testing.assert_allclose(tf, jf, rtol=1e-3)
    # and it solves the planted problem, as tests/test_lm.py requires
    assert tc[-1] < 1e-4 * tc[0]
    assert np.abs(to[:, :3, 3] - d["cam2w"][:, :3, 3]).max() < 1e-2


def test_lm_normal_equations_match_jax(synthetic_ba, rng):  # noqa: F811
    d = synthetic_ba
    noisy = _perturb_lm(d["cam2w"], rng)
    c = noisy.shape[0]
    st = jlm.chain_to_absolute(jnp.asarray(noisy), jnp.asarray(d["focals"]))
    thetas = np.asarray(jnp.concatenate(
        [st.quats, st.trans, st.log_focals[:, None]], axis=1))
    j_h, j_g, j_cost = jlm._shard_normal_eqs(
        jnp.asarray(thetas), *(jnp.asarray(d[k]) for k in
                               ("img1", "idx1", "img2", "idx2", "conf")),
        jnp.asarray(d["core_pix"]), jnp.asarray(d["pps"]),
        jnp.asarray(d["depths"]), c)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64))
    t_h, t_g, t_cost = tlm._normal_eqs(
        torch.as_tensor(thetas), i64(d["img1"]), i64(d["idx1"]),
        i64(d["img2"]), i64(d["idx2"]), torch.as_tensor(d["conf"]),
        torch.as_tensor(d["core_pix"]), torch.as_tensor(d["pps"]),
        torch.as_tensor(d["depths"]))
    j_h, j_g = np.asarray(j_h), np.asarray(j_g)
    np.testing.assert_allclose(t_h.numpy(), j_h,
                               atol=1e-4 * np.abs(j_h).max())
    np.testing.assert_allclose(t_g.numpy(), j_g,
                               atol=1e-4 * np.abs(j_g).max())
    np.testing.assert_allclose(float(t_cost), float(j_cost), rtol=1e-5)


@pytest.fixture(scope="module")
def seq():
    """tests/test_schur.py's instance: the sequence and its perturbed
    start drawn from one generator seeded 0."""
    rng = np.random.default_rng(0)
    d = _make_seq(rng)
    d["noisy"] = _perturb_seq(d["cam2w"], rng)
    return d


def test_build_tracks_equals_jax(seq):
    rng = np.random.default_rng(1)
    c, s = seq["c"], seq["core_pix"].shape[0]
    # the windowed sequence's pairs plus random chains that merge tracks
    # across cameras and some zero-confidence correspondences
    m = 600
    img1 = rng.integers(0, c, m).astype(np.int32)
    img2 = rng.integers(0, c, m).astype(np.int32)
    idx1 = rng.integers(0, s, m).astype(np.int32)
    idx2 = rng.integers(0, s, m).astype(np.int32)
    conf = rng.uniform(0, 2, m).astype(np.float32)
    conf[rng.random(m) < 0.2] = 0.0
    for max_obs in (3, 8):
        want = jschur.build_tracks(img1, idx1, img2, idx2, conf, c, s,
                                   max_obs=max_obs)
        got = tschur.build_tracks(img1, idx1, img2, idx2, conf, c, s,
                                  max_obs=max_obs)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for n_dev in (1, 4, 8):
            assert (tschur.schur_partition_sizes(got, n_dev)
                    == jschur.schur_partition_sizes(want, n_dev))
    t = seq["tracks"]
    assert t.cam.shape == (7 * seq["npts"], 8)


def test_schur_reduced_system_matches_jax(seq):
    rng = np.random.default_rng(2)
    noisy = _perturb_seq(seq["cam2w"], rng)
    c = noisy.shape[0]
    thetas = np.concatenate(
        [np.asarray(jschur.rotmat_to_quat(jnp.asarray(noisy[:, :3, :3]))),
         noisy[:, :3, 3], np.log(seq["focals"])[:, None]], axis=1)
    tr = seq["tracks"]
    j_s, j_g, j_cost = jschur._shard_reduced_system(
        jnp.asarray(thetas), jnp.asarray(tr.cam), jnp.asarray(tr.pt),
        jnp.asarray(tr.w), jnp.asarray(seq["core_pix"]),
        jnp.asarray(seq["pps"]), jnp.asarray(seq["depths"]), c)
    # chunk 48: several chunks and a partial last one
    t_s, t_g, t_cost = tschur._reduced_system(
        torch.as_tensor(thetas), torch.as_tensor(tr.cam.astype(np.int64)),
        torch.as_tensor(tr.pt.astype(np.int64)), torch.as_tensor(tr.w),
        torch.as_tensor(seq["core_pix"]), torch.as_tensor(seq["pps"]),
        torch.as_tensor(seq["depths"]), chunk=48)
    j_s, j_g = np.asarray(j_s), np.asarray(j_g)
    np.testing.assert_allclose(t_s.numpy(), j_s,
                               atol=1e-4 * np.abs(j_s).max())
    np.testing.assert_allclose(t_g.numpy(), j_g,
                               atol=1e-4 * np.abs(j_g).max())
    np.testing.assert_allclose(float(t_cost), float(j_cost), rtol=1e-4)


def test_schur_refine_matches_jax(seq):
    args = (seq["noisy"], seq["focals"], seq["pps"], seq["depths"],
            seq["core_pix"], seq["tracks"])
    jo, jf, jc = jschur.schur_refine(*args, iters=15, opt_focal=False)
    to, tf, tc = tschur.schur_refine(*args, iters=15, opt_focal=False,
                                     device="cpu")
    assert len(tc) == 15
    np.testing.assert_allclose(tc, jc, rtol=2e-2, atol=1e-8)
    np.testing.assert_allclose(to, jo, atol=1e-3)
    np.testing.assert_allclose(tf, jf, rtol=1e-6)
    # and it recovers the planted trajectory, as tests/test_schur.py
    assert tc[-1] < 1e-4 * tc[0]
    t_err = np.linalg.norm(to[:, :3, 3] - seq["cam2w"][:, :3, 3], axis=1)
    assert t_err.max() < 2e-2


def _colors(sh, sw, seed):
    """Two regions and a smooth ramp, with noise: a basis with structure."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:sh, 0:sw]
    region = (xx > sw // 2).astype(np.float64)
    cols = np.stack([region, 1 - region, yy / sh], -1)
    cols += rng.normal(size=cols.shape) * 0.05
    return cols.reshape(-1, 3).astype(np.float32)


@pytest.mark.parametrize("grid,k", [((12, 16), 24), ((46, 46), 6)])
def test_lowrank_basis_bit_equal_to_jax(grid, k):
    """(12, 16): the dense eigh route; (46, 46) = 2116 > 2048 cells: the
    seeded eigsh route."""
    cols = _colors(*grid, seed=4)
    got = tspectral.lowrank_basis(cols, grid, k=k)
    want = jspectral.lowrank_basis(cols, grid, k=k)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_spectral_projection_bit_equal_to_jax():
    sh, sw = 8, 12
    cols = np.stack([_colors(sh, sw, seed) for seed in (5, 6, 7)])
    depth = np.random.default_rng(8).uniform(
        1, 2, size=(3, sh * sw)).astype(np.float32)
    tc, tb = tspectral.spectral_projection_of_depthmaps(cols, depth,
                                                        (sh, sw), k=20)
    jc, jb = jspectral.spectral_projection_of_depthmaps(cols, depth,
                                                        (sh, sw), k=20)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tb, jb)


def _in_root_frame(cam2w, root):
    c = np.asarray(cam2w, np.float64)
    return np.linalg.inv(c[root])[None] @ c


@pytest.mark.parametrize("opt_depth", [True, False])
def test_lora_global_alignment_matches_jax(opt_depth):
    data, mst, _, _ = synthetic_ga_scene(n_cams=4, hw=64, subsample=8,
                                         focal=90.0, anchored=True)
    s = data.core_pix.shape[0]                   # an 8 x 8 core grid
    cols = np.stack([_colors(8, 8, seed) for seed in range(4)])
    assert cols.shape[1] == s
    coeffs, basis = tspectral.spectral_projection_of_depthmaps(
        cols, np.asarray(data.core_depth), (8, 8), k=16)
    kw = dict(niter1=15, niter2=8, lora_depth=True, lora_k=16,
              opt_depth=opt_depth)
    j_res, j_par = j_run_ga(data, mst, GAConfig(**kw), depth_basis=basis,
                            depth_coeffs=coeffs)
    t_res, t_par = t_run_ga(CondensedData(**data._asdict()), mst,
                            TGAConfig(**kw), depth_basis=basis,
                            depth_coeffs=coeffs, device="cpu")
    assert t_par.core_depth.shape == (4, 16)
    root = mst[0]
    np.testing.assert_allclose(_in_root_frame(t_res.cam2w.numpy(), root),
                               _in_root_frame(np.asarray(j_res.cam2w), root),
                               atol=1e-4)
    np.testing.assert_allclose(t_res.K.numpy(), np.asarray(j_res.K),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_res.depth.numpy(), np.asarray(j_res.depth),
                               atol=1e-4)
    np.testing.assert_allclose(t_par.core_depth.numpy(),
                               np.asarray(j_par.core_depth), atol=1e-4)
    np.testing.assert_allclose(t_res.loss_coarse, j_res.loss_coarse,
                               rtol=1e-4)
    np.testing.assert_allclose(t_res.loss_fine, j_res.loss_fine, rtol=1e-4)
    # a warm start from dense depth into lora coefficients is refused
    with pytest.raises(ValueError, match="parameterisation"):
        t_run_ga(CondensedData(**data._asdict()), mst,
                 TGAConfig(**kw), prev_params=t_par._replace(
                     core_depth=torch.zeros(4, s)), depth_basis=basis,
                 depth_coeffs=coeffs, device="cpu")
