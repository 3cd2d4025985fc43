"""Schur-complement bundle adjustment over tracks (port of
`starst3r_tpu/alignment/schur.py`).

Pairwise 3D-3D correspondences are merged transitively into TRACKS
(union-find over (camera, core point) endpoints): every observation
(camera k, core pixel, fixed GA depth) of track m claims one latent world
point X_m. With residuals r_k = X_m - W_k(theta_k) the point Jacobian is
the identity, so eliminating all world points is closed-form and exact:

    S    = sum_k w_k J_k^T J_k  -  sum_m G_m^T G_m / wsum_m
    g    = sum_k w_k J_k^T r_k          (r_k = W_k - X*_m,
    X*_m = sum_k w_k W_k / wsum_m        the eliminated optimum)
    G_m  = sum_k w_k J_k                 (3 x 8 per track and camera)

i.e. Gauss-Newton on F(theta) = min_X sum w |X - W(theta)|^2. Cameras are
8-parameter blocks (quat 4, trans 3, log-focal 1); camera 0 is frozen for
the gauge.

On the device: tracks stream through a loop over chunks of 2048 (the JAX
package's `lax.scan` chunks); per chunk the observations' world points and
3 x 8 Jacobians (`torch.func.vmap` over `jacfwd`), the per-camera segment
sums of the gradient and of the diagonal blocks, and the Schur correction
as 8 x 8 blocks G_ma^T G_mb / wsum_m of every pair of a track's
observations scattered into the (C, 8, C, 8) system, each with
`ops/row_sum.py::index_add_rows` (on the card the row-sum kernel in a
fixed order, so a polish gives the same bits every time; on the CPU
``index_add_``). Every product is an elementwise float32 product and sum,
so no TF32 matmul rounds it (the JAX package runs them at
`Precision.HIGHEST`). With a ``mesh`` the tracks
are padded to a multiple of the mesh size, split contiguously over its
first axis (the keyframe-block partitioning) and the partial (S, g, cost)
summed with an all-reduce, as `lm.py` does with correspondences.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..ops.row_sum import index_add_rows
from ..utils.device import resolve_device
from ..utils.se3 import rotmat_to_quat
from .lm import (gauss_newton, sharded_system, thetas_to_numpy,
                 unproject_one)

__all__ = ("Tracks", "build_tracks", "schur_refine",
           "schur_partition_sizes")

_NP = 8  # per-camera params: quat(4) + trans(3) + log_focal(1)

_world = vmap(unproject_one)
_world_jac = vmap(jacfwd(unproject_one))


class Tracks(NamedTuple):
    """Padded track observations. M tracks x K observation slots."""

    cam: np.ndarray      # (M, K) int32 camera index (0 where invalid)
    pt: np.ndarray       # (M, K) int32 core-grid index
    w: np.ndarray        # (M, K) float32 confidence weight, 0 = invalid


def build_tracks(corr_img1, corr_idx1, corr_img2, corr_idx2, corr_conf,
                 n_cams: int, core_size: int, max_obs: int = 8,
                 min_obs: int = 2) -> Tracks:
    """Union-find merge of correspondence endpoints into tracks.

    Node id = cam * core_size + core_idx. Zero-conf correspondences are
    ignored. Observation weight = max conf of any correspondence touching
    that endpoint. Tracks are padded to ``max_obs`` slots; tracks with more
    observations are SPLIT into camera-ordered sub-tracks with one
    overlapping observation (a chain), so every keyframe stays
    constrained (the keyframe-block partitioning of long tracks).
    """
    n_nodes = n_cams * core_size
    parent = np.arange(n_nodes, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    conf = np.asarray(corr_conf, np.float32)
    keep = conf > 0
    n1 = (np.asarray(corr_img1, np.int64) * core_size
          + np.asarray(corr_idx1, np.int64))[keep]
    n2 = (np.asarray(corr_img2, np.int64) * core_size
          + np.asarray(corr_idx2, np.int64))[keep]
    wk = conf[keep]
    for a, b in zip(n1, n2):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    node_w = np.zeros(n_nodes, np.float32)
    np.maximum.at(node_w, n1, wk)
    np.maximum.at(node_w, n2, wk)
    nodes = np.nonzero(node_w > 0)[0]
    roots = np.array([find(a) for a in nodes])
    order = np.argsort(roots, kind="stable")
    nodes, roots = nodes[order], roots[order]
    starts = np.nonzero(np.r_[True, roots[1:] != roots[:-1]])[0]
    ends = np.r_[starts[1:], len(roots)]

    cams, pts, ws = [], [], []

    def emit(grp, gw):
        pad = max_obs - len(grp)
        cams.append(np.r_[grp // core_size, np.zeros(pad, np.int64)])
        pts.append(np.r_[grp % core_size, np.zeros(pad, np.int64)])
        ws.append(np.r_[gw, np.zeros(pad, np.float32)])

    for s, e in zip(starts, ends):
        grp = nodes[s:e]
        if len(grp) < min_obs:
            continue
        gw = node_w[grp]
        order2 = np.argsort(grp // core_size)  # camera order (chain)
        grp, gw = grp[order2], gw[order2]
        if len(grp) <= max_obs:
            emit(grp, gw)
        else:
            step_ = max_obs - 1  # one-obs overlap links the sub-tracks
            for s0 in range(0, len(grp) - 1, step_):
                part = slice(s0, min(s0 + max_obs, len(grp)))
                if part.stop - part.start >= min_obs:
                    emit(grp[part], gw[part])
    if not cams:
        z = np.zeros((0, max_obs))
        return Tracks(z.astype(np.int32), z.astype(np.int32),
                      z.astype(np.float32))
    return Tracks(np.stack(cams).astype(np.int32),
                  np.stack(pts).astype(np.int32),
                  np.stack(ws).astype(np.float32))


def _reduced_system(thetas, t_cam, t_pt, t_w, core_pix, pps, depths,
                    with_system: bool = True, chunk: int = 2048):
    """(S (8C, 8C), g (8C,), cost) of the tracks at ``thetas`` (C, 8);
    with ``with_system=False`` only the cost (S and g are None).
    t_cam, t_pt (Ms, K) int64, t_w (Ms, K) float32 (0 = empty slot)."""
    c = thetas.shape[0]
    n = c * _NP
    dev, dt = thetas.device, thetas.dtype
    cost = torch.zeros((), dtype=dt, device=dev)
    g = torch.zeros((c, _NP), dtype=dt, device=dev)
    s_diag = torch.zeros((c, _NP, _NP), dtype=dt, device=dev)
    s_corr = torch.zeros(n * n, dtype=dt, device=dev)
    ar = torch.arange(_NP, device=dev)
    k = t_cam.shape[1]
    for start in range(0, t_cam.shape[0], chunk):
        tc = t_cam[start:start + chunk]
        tp = t_pt[start:start + chunk]
        w = t_w[start:start + chunk]                        # (Mc, K)
        mc = tc.shape[0]
        cam, pt = tc.reshape(-1), tp.reshape(-1)
        args = (thetas[cam], core_pix[pt], pps[cam], depths[cam, pt])
        W = _world(*args).reshape(mc, k, 3)
        wsum = torch.clamp(w.sum(dim=1), min=1e-12)         # (Mc,)
        x_star = (w[..., None] * W).sum(dim=1) / wsum[:, None]
        r = W - x_star[:, None, :]                          # (Mc, K, 3)
        cost = cost + 0.5 * torch.sum(w * torch.sum(r * r, dim=-1))
        if not with_system:
            continue
        # empty slots get no Jacobian (theirs would be real otherwise)
        J = _world_jac(*args).reshape(mc, k, 3, _NP) \
            * (w > 0)[..., None, None].to(dt)
        # gradient: w J^T r per observation, summed per camera (r is
        # centred, so the point term vanishes)
        g_obs = torch.sum(J * r[..., None], dim=2) * w[..., None]
        index_add_rows(g, (cam, g_obs.reshape(-1, _NP)))
        # diagonal observation term: w J^T J per camera
        jtj = torch.sum(J[..., :, None] * J[..., None, :], dim=2)
        index_add_rows(s_diag, (cam, (jtj * w[..., None, None])
                                .reshape(-1, _NP, _NP)))
        # Schur correction: -(w_a J_a)^T (w_b J_b) / wsum for every pair
        # (a, b) of a track's observations, at block (cam_a, cam_b)
        wj = J * (w / torch.sqrt(wsum)[:, None])[..., None, None]
        blk = torch.sum(wj[:, :, None, :, :, None]
                        * wj[:, None, :, :, None, :], dim=3)  # (Mc,K,K,8,8)
        rows = tc[:, :, None, None, None] * _NP + ar[:, None]  # (Mc,K,1,8,1)
        cols = tc[:, None, :, None, None] * _NP + ar           # (Mc,1,K,1,8)
        index_add_rows(s_corr, ((rows * n + cols).reshape(-1),
                                -blk.reshape(-1)))
    if not with_system:
        return None, None, cost
    S = s_corr.reshape(c, _NP, c, _NP)
    idx = torch.arange(c, device=dev)
    S[idx, :, idx, :] += s_diag
    return S.reshape(n, n), g.reshape(-1), cost


def schur_partition_sizes(tracks: "Tracks", n_dev: int) -> list:
    """Valid-observation count per device shard under the keyframe-block
    track partitioning of the JAX package's `schur_refine(mesh=...)`
    (tracks padded to a multiple of n_dev, then split contiguously over
    the devices): the work-balance diagnostic for a sharded reduction."""
    m = tracks.cam.shape[0]
    pad = (-m) % n_dev
    w = np.concatenate(
        [tracks.w, np.zeros((pad,) + tracks.w.shape[1:], np.float32)])
    per = w.reshape(n_dev, -1, w.shape[-1])
    return [int((s > 0).sum()) for s in per]


def schur_refine(
    cam2w: np.ndarray,
    focals: np.ndarray,
    pps: np.ndarray,
    depths: np.ndarray,
    core_pix: np.ndarray,
    tracks: Tracks,
    iters: int = 10,
    damping: float = 1e-3,
    mesh=None,
    opt_focal: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Damped Gauss-Newton on the Schur-reduced camera system, on
    ``device`` (the card unless "cpu").

    cam2w (C, 4, 4), focals (C,), pps (C, 2) pixel principal points,
    depths (C, S) fixed metric core depth, core_pix (S, 2). ``mesh``: the
    tracks sharded over its first axis (module docstring). Returns
    (cam2w', focals', the cost after each iteration)."""
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
    cam2w = f32(cam2w)
    thetas = torch.cat([rotmat_to_quat(cam2w[:, :3, :3]), cam2w[:, :3, 3],
                        torch.log(f32(focals))[:, None]], dim=1)  # (C, 8)
    fixed = (f32(core_pix), f32(pps), f32(depths))

    def system_of(t):
        data = (i64(t[0]), i64(t[1]), f32(t[2]), *fixed)
        return lambda th, full: _reduced_system(th, *data, with_system=full)

    arrays = [np.asarray(tracks.cam), np.asarray(tracks.pt),
              np.asarray(tracks.w, np.float32)]
    if mesh is None:
        system, sync = system_of(arrays), None
    else:
        system, sync = sharded_system(mesh, arrays, system_of)
    thetas, costs = gauss_newton(thetas, system, iters, damping, opt_focal,
                                 sync)
    out, focals_out = thetas_to_numpy(thetas)
    return out, focals_out, costs
