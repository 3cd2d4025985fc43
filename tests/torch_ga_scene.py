"""The GA scene of tests/test_torch_ga.py built from the port's own
`utils.synthetic` (equal bit for bit to the JAX package's), for the port's
GA tests that must not import JAX (tests/test_torch_cuda.py).

The planted-pose sphere scene (anchored endpoints, 4 cameras, 64 px, an
8 x 8 core grid), with two pairs marked as failed matches so the dust3r
fallback loss is live, a noisy fallback target and scaled confidences.
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
