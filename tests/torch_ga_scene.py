"""The GA scene of tests/test_torch_ga.py built from the port's own
`utils.synthetic` (equal bit for bit to the JAX package's), for the port's
GA tests that must not import JAX (tests/test_torch_cuda.py).

The planted-pose sphere scene (anchored endpoints, 4 cameras, 64 px, an
8 x 8 core grid), with two pairs marked as failed matches so the dust3r
fallback loss is live, a noisy fallback target and scaled confidences.

Also the shapes of the GA's six row gathers on the main path, and rows
long and short enough for each of the kernel's launch shapes
(`gather_case`), for the row-gather backward's CPU and GPU tests.
"""

import numpy as np

from starst3r_tpu_torch.utils.synthetic import synthetic_ga_scene


def ga_scene(n_cams=4, seed=0):
    """(CondensedData, mst) of tests/test_torch_ga.py::_scene."""
    data, mst, _, _ = synthetic_ga_scene(n_cams=n_cams, hw=64, subsample=8,
                                         focal=90.0, anchored=True)
    rng = np.random.default_rng(seed)
    p = data.pair_img1.shape[0]
    ok = np.ones(p, bool)
    ok[rng.choice(p, size=2, replace=False)] = False
    s = data.core_pix.shape[0]
    preds = rng.normal(size=(p, s, 3)).astype(np.float32) * 0.05
    preds[..., 2] += 4.0
    data = data._replace(
        pair_matching_ok=ok, preds21_pts=preds,
        preds21_conf=rng.uniform(1, 2, size=(p, s)).astype(np.float32),
        corr_conf=(data.corr_conf * rng.uniform(1, 3, size=data.corr_conf
                                                .shape)).astype(np.float32))
    return data, mst


GATHER_S = 784          # core points of a 224 px view at subsample 8
GATHER_M = 20_000       # correspondences, about what the main path's GA holds
GATHER_SITES = ("depth", "K", "cam2w", "proj", "pair_cam2w", "pair_pts3d")


# one camera row of the 512 px operating point's correspondences, rounded
# up (tests/test_ga_groundtruth.py::test_ga_512px_scale_memory: 36,864 a
# camera, 368,640 in all)
LONG_ROW = 368_640


def gather_case(name, c=6, seed=0, m=GATHER_M, s=GATHER_S):
    """(R, idx (M,) int64, ct (M, D) float32) of one of the JAX GA's six
    `_gather_rows` sites at C = c cameras, S = s core points, M = m
    correspondences and P = c (c - 1) pairs; or "empty_rows", a
    depth-shaped index over the first two cameras' rows only; "one_row",
    an index whose entries all fall in one of the C rows; "long_row", one
    row of LONG_ROW entries (the kernel splits it over a cluster of
    blocks); "split_short_row", a row of 40,000 entries beside one of 3,
    shuffled (the kernel splits both rows alike, so a block of the short
    row's cluster gets no entry)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, c, m)
    pairs = rng.integers(0, c, c * (c - 1))
    r, d, idx = {
        "depth": (c * s, 1, img * s + rng.integers(0, s, m)),
        "K": (c, 9, img), "cam2w": (c, 16, img), "proj": (c, 12, img),
        "pair_cam2w": (c, 16, pairs), "pair_pts3d": (c, s * 3, pairs),
        "empty_rows": (c * s, 1, rng.integers(0, 2 * s, 500)),
        "one_row": (c, 16, np.full(m, 2)),
        "long_row": (c, 16, np.full(LONG_ROW, 1)),
        "split_short_row": (c, 16, np.random.default_rng(seed + 1)
                            .permutation(np.repeat([0, 3], [40_000, 3])))
    }[name]
    ct = (3.0 * rng.normal(size=(len(idx), d))).astype(np.float32)
    return r, idx.astype(np.int64), ct


def condensed_case(h, w, n_views=6, seed=0, subsample=8):
    """(CondensedData, mst) at the condensed shape of ``n_views`` h x w
    views (S = (h / subsample) (w / subsample) core points, every ordered
    pair, S correspondences a pair with anchored endpoints), from random
    numbers: median depths 2-5 and core depths within 10% of them (so the
    reparameterised cameras see every point well in front of them), two
    pairs below the matching threshold so the fallback is live, an MST
    chain from camera 0. The shapes of the benchmark's recon cells (224 x
    160: S = 560; 512 x 384: S = 3,072) for the fused loss's tests."""
    from starst3r_tpu_torch.alignment.condense import CondensedData
    rng = np.random.default_rng(seed)
    c = n_views
    hs, ws = h // subsample, w // subsample
    s = hs * ws
    yy, xx = np.mgrid[0:hs, 0:ws]
    core_pix = np.stack([xx.reshape(-1), yy.reshape(-1)], -1).astype(
        np.float32) * subsample + subsample // 2
    pairs = [(i, j) for i in range(c) for j in range(c) if i != j]
    p = len(pairs)
    pair_img1 = np.array([a for a, _ in pairs], np.int32)
    pair_img2 = np.array([b for _, b in pairs], np.int32)
    m = p * s
    corr_pair = np.repeat(np.arange(p), s).astype(np.int32)
    corr_idx1 = rng.integers(0, s, m).astype(np.int32)
    corr_idx2 = rng.integers(0, s, m).astype(np.int32)
    ok = np.ones(p, bool)
    ok[rng.choice(p, size=2, replace=False)] = False
    jitter = lambda idx: (core_pix[idx] + rng.uniform(
        -subsample / 2, subsample / 2, (m, 2))).astype(np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    data = CondensedData(
        imsizes=f32(np.tile([w, h], (c, 1))),
        pps=f32(0.5 + rng.uniform(-0.02, 0.02, (c, 2))),
        base_focals=f32(rng.uniform(0.9, 1.1, c) * max(h, w)),
        core_depth=f32(rng.uniform(0.9, 1.1, (c, s))),
        median_depths=f32(rng.uniform(2.0, 5.0, c)),
        core_pix=core_pix,
        corr_img1=pair_img1[corr_pair], corr_idx1=corr_idx1,
        corr_img2=pair_img2[corr_pair], corr_idx2=corr_idx2,
        corr_conf=f32(rng.uniform(1.0, 3.0, m)), corr_pair=corr_pair,
        pair_img1=pair_img1, pair_img2=pair_img2, pair_matching_ok=ok,
        preds21_pts=f32(rng.normal(size=(p, s, 3)) * 0.3 + [0, 0, 3]),
        preds21_conf=f32(rng.uniform(1.0, 2.0, (p, s))),
        corr_pix1=jitter(corr_idx1), corr_pix2=jitter(corr_idx2),
        corr_doff1=f32(rng.uniform(0.9, 1.1, m)),
        corr_doff2=f32(rng.uniform(0.9, 1.1, m)))
    return data, (0, [(i, i + 1) for i in range(c - 1)])
