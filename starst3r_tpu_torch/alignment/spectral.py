"""Spectral low-rank depth (the reference's ``lora_depth``; port of
`starst3r_tpu/alignment/spectral.py`, the same numpy and scipy code, so the
two give the same bits on the same inputs).

Reference behaviour (starster/reconstruct.py:123, 251-252, 270-273): with
``lora_depth=dict(k=96, gamma=15, min_norm=.5)`` each image's core depth is
re-parameterised as ``k`` coefficients over a low-rank spectral basis of its
core grid; inside the optimisation the dense core depth is
``basis[i] @ coeffs[i]``. Optimising k coefficients instead of S dense
values keeps the depth piecewise smooth along image structure.

The basis is built once per image on the host (the normalised graph
Laplacian of the core grid, edge weights from image appearance, a dense
``eigh`` up to S = 2048 and a seeded ``eigsh`` above); in the GA loss the
expansion is one batched (C, S, k) x (C, k) product on the device
(`alignment/ga.py::make_K_cam_depth`). scipy is imported only when a basis
is built.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ("lowrank_basis", "spectral_projection_of_depthmaps")


def lowrank_basis(colors: np.ndarray, grid_hw: Tuple[int, int], k: int = 96,
                  gamma: float = 15.0, min_norm: float = 0.5) -> np.ndarray:
    """Low-rank spectral basis of one image's core grid.

    ``colors`` (S, D) per-core-pixel appearance (any channel count),
    ``grid_hw`` = (Sh, Sw) with S = Sh*Sw. Returns (S, k) float32.

    Edge weights between 4-neighbors on the core grid are
    ``exp(-gamma * ||c_i - c_j||^2)`` — strong edges within smooth regions,
    weak edges across image boundaries — so the smallest eigenvectors of
    the normalized Laplacian are smooth within objects and free to jump
    across depth discontinuities. ``min_norm`` guards representation:
    basis rows whose norm falls below ``min_norm *`` the mean row norm are
    rescaled up so every pixel's depth stays adjustable (the role of the
    reference's min_norm=.5 knob).
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    sh, sw = grid_hw
    s = sh * sw
    if s != colors.shape[0]:
        raise ValueError(f"grid {grid_hw} != colors rows {colors.shape[0]}")
    k = int(min(k, s))
    cg = np.asarray(colors, np.float64).reshape(sh, sw, -1)

    wh = np.exp(-gamma * ((cg[:, 1:] - cg[:, :-1]) ** 2).sum(-1))  # (sh,sw-1)
    wv = np.exp(-gamma * ((cg[1:] - cg[:-1]) ** 2).sum(-1))        # (sh-1,sw)
    idx = np.arange(s).reshape(sh, sw)
    rows = np.concatenate([idx[:, :-1].ravel(), idx[:-1].ravel()])
    cols = np.concatenate([idx[:, 1:].ravel(), idx[1:].ravel()])
    vals = np.concatenate([wh.ravel(), wv.ravel()])
    W = sp.coo_matrix((np.concatenate([vals, vals]),
                       (np.concatenate([rows, cols]),
                        np.concatenate([cols, rows]))), shape=(s, s)).tocsr()
    deg = np.asarray(W.sum(axis=1)).ravel() + 1e-12
    dmh = sp.diags(1.0 / np.sqrt(deg))
    lap = sp.identity(s) - dmh @ W @ dmh

    if s <= 2048 or k >= s - 2:
        evals, evecs = np.linalg.eigh(lap.toarray())
        basis = evecs[:, :k]
    else:
        # shift-invert around 0: the k smallest eigenpairs of the PSD
        # Laplacian without forming the dense matrix (512px -> S=4096).
        # Deterministic: seeded ARPACK start vector (the default is
        # np.random-global), plus the sign convention below — warm-started
        # GA coefficients stay valid across re-runs.
        v0 = np.random.default_rng(0).standard_normal(s)
        evals, basis = spla.eigsh(lap.tocsc(), k=k, sigma=-1e-4, which="LM",
                                  v0=v0)
        order = np.argsort(evals)
        basis = basis[:, order]

    # sign convention (eigenvector signs are arbitrary per solver/BLAS):
    # make each column's largest-magnitude entry positive
    jmax = np.argmax(np.abs(basis), axis=0)
    signs = np.sign(basis[jmax, np.arange(basis.shape[1])])
    signs[signs == 0] = 1.0
    basis = basis * signs

    # min_norm guard, iterated to a FIXED POINT: scaling rows up raises the
    # mean, so a single pass can leave rows below min_norm * new_mean.
    # Converges for min_norm < 1 (the mean is bounded by the max row norm).
    rn = np.linalg.norm(basis, axis=1)
    for _ in range(100):
        target = min_norm * rn.mean()
        if rn.min() >= target * (1.0 - 1e-12):
            break
        scale = np.maximum(1.0, target / np.maximum(rn, 1e-12))
        basis = basis * scale[:, None]
        rn = rn * scale
    return basis.astype(np.float32)


def spectral_projection_of_depthmaps(
        core_colors: np.ndarray, core_depth: np.ndarray,
        grid_hw: Tuple[int, int], k: int = 96, gamma: float = 15.0,
        min_norm: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    """Batched basis + initial coefficients for all images.

    ``core_colors`` (C, S, D), ``core_depth`` (C, S). Returns
    ``(coeffs (C, k), basis (C, S, k))`` with ``basis[i] @ coeffs[i]`` the
    least-squares fit of image i's initial core depth — the counterpart of
    the reference's (core_depth, lora_depth_proj) pair
    (starster/reconstruct.py:270-273)."""
    c, s = core_depth.shape
    bases = np.stack([
        lowrank_basis(core_colors[i], grid_hw, k, gamma, min_norm)
        for i in range(c)
    ])                                                      # (C, S, k)
    coeffs = np.stack([
        np.linalg.lstsq(bases[i], core_depth[i].astype(np.float64),
                        rcond=None)[0]
        for i in range(c)
    ]).astype(np.float32)                                   # (C, k)
    return coeffs, bases
