"""The port's matching, canonical views, condensation and MST, and its
camera/SE(3)/imaging helpers, against the JAX package on the same inputs.

Inputs are made from numpy seeds. Matching is compared index for index on
descriptors whose best and second-best similarities are well apart (no
near-ties, so argmax cannot flip between summation orders); canonical views
and condensation at 1e-5, fed the same pair predictions.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from starst3r_tpu import imaging as jimaging
from starst3r_tpu.alignment import canonical as jcanon
from starst3r_tpu.alignment.condense import condense as j_condense
from starst3r_tpu.alignment.mst import max_spanning_tree as j_mst
from starst3r_tpu.models.mast3r import PairPrediction as JPred
from starst3r_tpu.ops import matching as jmatch
from starst3r_tpu.utils import camera as jcam
from starst3r_tpu.utils import se3 as jse3

from starst3r_tpu_torch import imaging as timaging
from starst3r_tpu_torch.alignment import canonical as tcanon
from starst3r_tpu_torch.alignment.condense import condense as t_condense
from starst3r_tpu_torch.alignment.mst import max_spanning_tree as t_mst
from starst3r_tpu_torch.models.mast3r import PairPrediction as TPred
from starst3r_tpu_torch.ops import matching as tmatch
from starst3r_tpu_torch.utils import camera as tcam
from starst3r_tpu_torch.utils import se3 as tse3

H = W = 64
SUB = 8
N_IMG = 3
FIELDS = ("pts1", "conf1", "pts2", "conf2", "desc1", "desc2", "desc_conf1",
          "desc_conf2")


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _predictions(seed=0):
    """Pair predictions for all ordered pairs of N_IMG images: positive
    depths, confidences >= 1, and descriptor maps where image j's map is a
    noisy shifted copy of image i's (many mutual matches)."""
    rng = np.random.default_rng(seed)
    base = _unit(rng.normal(size=(N_IMG, H, W, 8))).astype(np.float32)
    preds = []
    for i, j in jimaging.make_pair_indices(N_IMG):
        def pts():
            p = rng.normal(size=(H, W, 3)).astype(np.float32) * 0.5
            p[..., 2] = rng.uniform(1.0, 3.0, size=(H, W))
            return p
        d2 = _unit(np.roll(base[i], 3, axis=1)
                   + 0.3 * rng.normal(size=(H, W, 8))).astype(np.float32)
        preds.append(dict(
            idx1=i, idx2=j, pts1=pts(), pts2=pts(),
            conf1=(1 + np.exp(rng.normal(size=(H, W)))).astype(np.float32),
            conf2=(1 + np.exp(rng.normal(size=(H, W)))).astype(np.float32),
            desc1=base[i], desc2=d2,
            desc_conf1=np.ones((H, W), np.float32),
            desc_conf2=np.ones((H, W), np.float32)))
    return preds


def _jax_preds(preds):
    return [JPred(**p) for p in preds]


def _torch_preds(preds):
    return [TPred(idx1=p["idx1"], idx2=p["idx2"],
                  **{f: torch.from_numpy(p[f]) for f in FIELDS})
            for p in preds]


def _min_gap(sim, axis):
    s = np.sort(sim, axis=axis)
    top2 = np.take(s, [-1, -2], axis=axis)
    return float(np.min(np.take(top2, 0, axis) - np.take(top2, 1, axis)))


@pytest.fixture(scope="module")
def preds():
    return _predictions()


def test_match_pair_identical_to_jax(preds):
    grid = np.asarray(jmatch.subsample_grid_indices(H, W, SUB)[0])
    for p in preds:
        d1 = p["desc1"].reshape(-1, 8)[grid]
        d2 = p["desc2"].reshape(-1, 8)[grid]
        sim = d1.astype(np.float64) @ d2.T
        # the inputs have no near-ties
        assert min(_min_gap(sim, 1), _min_gap(sim, 0)) > 1e-4
        jm = jmatch.match_pair(*(jnp.asarray(p[f]) for f in
                                 ("desc1", "desc2", "conf1", "conf2")),
                               subsample=SUB)
        tm = tmatch.match_pair(*(torch.from_numpy(p[f]) for f in
                                 ("desc1", "desc2", "conf1", "conf2")),
                               subsample=SUB)
        np.testing.assert_array_equal(tm.idx1.numpy(), np.asarray(jm.idx1))
        np.testing.assert_array_equal(tm.idx2.numpy(), np.asarray(jm.idx2))
        np.testing.assert_array_equal(tm.mask.numpy(), np.asarray(jm.mask))
        assert tm.mask.sum() > 10
        np.testing.assert_allclose(tm.conf.numpy(), np.asarray(jm.conf),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm.sim.numpy(), np.asarray(jm.sim),
                                   atol=1e-6)
        jp1, jp2 = jmatch.refine_matches(jnp.asarray(p["desc1"]),
                                         jnp.asarray(p["desc2"]), jm,
                                         subsample=SUB)
        tp1, tp2 = tmatch.refine_matches(torch.from_numpy(p["desc1"]),
                                         torch.from_numpy(p["desc2"]), tm,
                                         subsample=SUB)
        np.testing.assert_array_equal(tp1.numpy(), np.asarray(jp1))
        np.testing.assert_array_equal(tp2.numpy(), np.asarray(jp2))


def _cmp_views(tviews, jviews):
    assert len(tviews) == len(jviews)
    for tv, jv in zip(tviews, jviews):
        for f in ("pts3d", "conf", "depth", "pp", "core_depth",
                  "anchor_offset"):
            np.testing.assert_allclose(getattr(tv, f), np.asarray(
                getattr(jv, f)), rtol=1e-5, atol=1e-5, err_msg=f)
        np.testing.assert_array_equal(tv.anchor_idx, jv.anchor_idx)
        np.testing.assert_allclose(tv.focal, jv.focal, rtol=1e-5)


@pytest.mark.parametrize("mode", ["avg-angle", "conf"])
def test_canonical_views_match_jax(preds, mode):
    jviews, j21 = jcanon.build_canonical_views(N_IMG, _jax_preds(preds),
                                               subsample=SUB, mode=mode)
    tviews, t21 = tcanon.build_canonical_views(N_IMG, _torch_preds(preds),
                                               subsample=SUB, mode=mode)
    _cmp_views(tviews, jviews)
    assert sorted(t21) == sorted(j21)
    for k in j21:
        for a, b in zip(t21[k], j21[k]):
            np.testing.assert_array_equal(a, b)


def test_condense_matches_jax(preds):
    """Each package runs its own matching and canonical views on the same
    predictions, then condenses; every CondensedData field agrees."""
    jp, tp = _jax_preds(preds), _torch_preds(preds)
    jviews, j21 = jcanon.build_canonical_views(N_IMG, jp, subsample=SUB)
    tviews, t21 = tcanon.build_canonical_views(N_IMG, tp, subsample=SUB)
    jm, jr, tm, tr = {}, {}, {}, {}
    for a, b in zip(jp, tp):
        m = jmatch.match_pair(jnp.asarray(a.desc1), jnp.asarray(a.desc2),
                              jnp.asarray(a.conf1), jnp.asarray(a.conf2),
                              subsample=SUB)
        jm[(a.idx1, a.idx2)] = jax.tree_util.tree_map(np.asarray, m)
        jr[(a.idx1, a.idx2)] = tuple(np.asarray(x) for x in
                                     jmatch.refine_matches(
                                         jnp.asarray(a.desc1),
                                         jnp.asarray(a.desc2), m, SUB))
        m = tmatch.match_pair(b.desc1, b.desc2, b.conf1, b.conf2, SUB)
        tm[(b.idx1, b.idx2)] = tmatch.PairMatches(*(x.numpy() for x in m))
        tr[(b.idx1, b.idx2)] = tuple(x.numpy() for x in
                                     tmatch.refine_matches(b.desc1, b.desc2,
                                                           m, SUB))
    for cap in (0, 20):
        jd = j_condense(jviews, jm, j21, (H, W), SUB, 5.0,
                        max_corres_per_pair=cap, refined=jr)
        td = t_condense(tviews, tm, t21, (H, W), SUB, 5.0,
                        max_corres_per_pair=cap, refined=tr)
        for f in jd._fields:
            a, b = getattr(td, f), getattr(jd, f)
            assert np.asarray(a).dtype == np.asarray(b).dtype, f
            if np.asarray(b).dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=f)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f)


def test_max_spanning_tree_matches_jax():
    s = np.random.default_rng(2).uniform(size=(7, 7))
    assert t_mst(s) == j_mst(s)


@pytest.mark.parametrize("mode", ["lerp", "slerp"])
def test_se3_path_matches_jax(mode):
    rng = np.random.default_rng(4)
    q = _unit(rng.normal(size=(2, 4))).astype(np.float32)
    jm = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    jm[:, :3, :3] = np.asarray(jse3.quat_to_rotmat(jnp.asarray(q)))
    jm[:, :3, 3] = rng.normal(size=(2, 3))
    np.testing.assert_allclose(
        tse3.quat_to_rotmat(torch.from_numpy(q)).numpy(), jm[:, :3, :3],
        atol=1e-6)
    tm = torch.from_numpy(jm)
    want = np.asarray(jse3.interp_se3_path(jnp.asarray(jm[0]),
                                           jnp.asarray(jm[1]), 6, mode=mode))
    got = tse3.interp_se3_path(jm[0], jm[1], 6, mode=mode)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        tse3.se3_inverse(tm).numpy(),
        np.asarray(jse3.se3_inverse(jnp.asarray(jm))), atol=1e-6)
    np.testing.assert_allclose(
        tse3.rotmat_to_quat(tm[:, :3, :3]).numpy(),
        np.asarray(jse3.rotmat_to_quat(jnp.asarray(jm[:, :3, :3]))),
        atol=1e-6)


def test_camera_helpers_match_jax():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(16, 12, 3)).astype(np.float32)
    pts[..., 2] = rng.uniform(1, 2, size=(16, 12))
    conf = rng.uniform(1, 3, size=(16, 12)).astype(np.float32)
    pp = np.array([6.0, 8.0], np.float32)
    f_j = float(jcam.estimate_focal_from_pointmap(
        jnp.asarray(pts), jnp.asarray(pp), jnp.asarray(conf)))
    f_t = float(tcam.estimate_focal_from_pointmap(
        torch.from_numpy(pts), torch.from_numpy(pp), torch.from_numpy(conf)))
    np.testing.assert_allclose(f_t, f_j, rtol=1e-5)
    np.testing.assert_array_equal(tcam.pixel_grid(5, 7).numpy(),
                                  np.asarray(jcam.pixel_grid(5, 7)))


def test_imaging_matches_jax():
    img = np.random.default_rng(6).integers(0, 256, size=(75, 101, 3),
                                            dtype=np.uint8)
    for size, mult in ((64, 16), (48, 8)):
        np.testing.assert_array_equal(
            timaging.process_image(img, size, crop_multiple=mult),
            jimaging.process_image(img, size, crop_multiple=mult))
    assert timaging.make_pair_indices(5) == jimaging.make_pair_indices(5)
    assert (timaging.make_sliding_window_pairs(6, 2)
            == jimaging.make_sliding_window_pairs(6, 2))
