"""Levenberg–Marquardt polish over absolute camera poses (port of
`starst3r_tpu/alignment/lm.py`).

The Adam GA (`ga.py`) optimises a chained (MST-relative) parameterisation,
in which every camera's world pose depends on all its chain ancestors.
Here the poses are re-parameterised as absolute (camera 0 frozen for the
gauge) and refined by damped Gauss–Newton: each 3D-3D correspondence
touches two cameras, so its residual has two 3×8 Jacobian blocks (8
parameters per camera: quat 4, trans 3, log-focal 1), and the dense
(8C)² normal matrix is assembled from their per-correspondence outer
products with index adds (`ops/row_sum.py::index_add_rows`: on the card
the row-sum kernel in a fixed order, so a polish gives the same bits every
time; on the CPU ``index_add_``). Core depths and principal points stay at
their GA values.

Everything runs on ``device`` (the card unless "cpu"); the host reads one
cost per iteration to accept or reject the step. With a ``mesh``
(`parallel.make_mesh`), every rank calls `lm_refine` with the same inputs:
the correspondences are padded (weight 0) to a multiple of the mesh size
and split contiguously over its first axis, each rank builds the normal
equations of its share, and the partial H, g and cost are summed with an
all-reduce; every rank solves the damped system and takes rank 0's step,
so the ranks accept and reject alike.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..ops.row_sum import index_add_rows
from ..utils.device import resolve_device
from ..utils.se3 import quat_normalize, quat_to_rotmat, rotmat_to_quat

__all__ = ("LMState", "lm_refine", "chain_to_absolute")

_NP = 8  # per-camera params: quat(4) + trans(3) + log_focal(1)


class LMState(NamedTuple):
    quats: torch.Tensor       # (C, 4) absolute cam2w rotation (wxyz)
    trans: torch.Tensor       # (C, 3) absolute cam2w translation
    log_focals: torch.Tensor  # (C,)


def chain_to_absolute(cam2w: torch.Tensor, focals: torch.Tensor) -> LMState:
    """LM state from (C, 4, 4) cam2w and (C,) focals (the GA's output)."""
    return LMState(quats=rotmat_to_quat(cam2w[:, :3, :3]),
                   trans=cam2w[:, :3, 3], log_focals=torch.log(focals))


def unproject_one(theta, pix, pp, z):
    """World point of one endpoint from its camera's packed (8,) params:
    the ray through ``pix`` at depth ``z``. Products are written out
    elementwise, so no TF32 matmul can round them."""
    R = quat_to_rotmat(quat_normalize(theta[:4]))
    f = torch.exp(theta[7])
    cam = torch.cat([(pix - pp) / f * z, z[None]])
    return torch.sum(R * cam, dim=-1) + theta[4:7]


def _residual_one(theta_i, theta_j, pix_i, pix_j, pp_i, pp_j, z_i, z_j):
    """3-vector residual of one correspondence."""
    return (unproject_one(theta_i, pix_i, pp_i, z_i)
            - unproject_one(theta_j, pix_j, pp_j, z_j))


_residuals = vmap(_residual_one)
_jacobians = vmap(jacfwd(_residual_one, argnums=(0, 1)))


def _outer(Ja, Jb, w):
    """sum_d w Ja[:, d, i] Jb[:, d, j] per correspondence: (M, 8, 8)."""
    return torch.sum(Ja[:, :, :, None] * Jb[:, :, None, :], dim=1) \
        * w[:, None, None]


def _normal_eqs(thetas, img1, idx1, img2, idx2, conf, core_pix, pps, depths,
                with_system: bool = True):
    """(H (8C, 8C), g (8C,), cost) of the correspondences at ``thetas``
    (C, 8); with ``with_system=False`` only the cost (H and g are None)."""
    c = thetas.shape[0]
    args = (thetas[img1], thetas[img2], core_pix[idx1], core_pix[idx2],
            pps[img1], pps[img2], depths[img1, idx1], depths[img2, idx2])
    r = _residuals(*args)                                      # (M, 3)
    cost = 0.5 * torch.sum(conf * torch.sum(r * r, dim=-1))
    if not with_system:
        return None, None, cost
    J1, J2 = _jacobians(*args)                                 # (M, 3, 8)
    wr = conf[:, None] * r
    n = c * _NP
    ar = torch.arange(_NP, device=thetas.device)
    bi = img1[:, None] * _NP + ar                              # (M, 8)
    bj = img2[:, None] * _NP + ar
    g = index_add_rows(
        torch.zeros(n, dtype=thetas.dtype, device=thetas.device),
        (bi.reshape(-1), torch.sum(J1 * wr[:, :, None], dim=1).reshape(-1)),
        (bj.reshape(-1), torch.sum(J2 * wr[:, :, None], dim=1).reshape(-1)))
    j12 = _outer(J1, J2, conf)
    blocks = ((bi, bi, _outer(J1, J1, conf)), (bj, bj, _outer(J2, J2, conf)),
              (bi, bj, j12), (bj, bi, j12.transpose(1, 2)))
    H = index_add_rows(
        torch.zeros(n * n, dtype=thetas.dtype, device=thetas.device),
        *(((rows[:, :, None] * n + cols[:, None, :]).reshape(-1),
           blk.reshape(-1)) for rows, cols, blk in blocks))
    return H.reshape(n, n), g, cost


def damped_step(H, g, lam: float, opt_focal: bool):
    """Solve the damped normal equations with camera 0 (and the focals
    unless ``opt_focal``) frozen: delta (C, 8)."""
    c = g.shape[0] // _NP
    mask = torch.ones((c, _NP), dtype=g.dtype, device=g.device)
    mask[0] = 0.0
    if not opt_focal:
        mask[:, 7] = 0.0
    mask = mask.reshape(-1)
    Hm = H * mask[:, None] * mask[None, :]
    Hm = Hm + torch.diag(lam * (torch.diagonal(Hm) + 1e-8) + (1.0 - mask))
    return torch.linalg.solve(Hm, -g * mask).reshape(c, _NP)


def gauss_newton(thetas, system, iters: int, damping: float,
                 opt_focal: bool, sync=None) -> Tuple[torch.Tensor, list]:
    """The LM loop shared with `schur.py`: ``system(thetas, with_system)``
    gives (H, g, cost). A step is accepted when its cost is lower (the one
    host read per iteration); λ halves on accept and quadruples on reject.
    ``sync``: maps each candidate to the one every rank takes."""
    lam = damping
    costs = []
    cur = float(system(thetas, False)[2])
    for _ in range(iters):
        H, g, _ = system(thetas, True)
        cand = thetas + damped_step(H, g, lam, opt_focal)
        cand = torch.cat([quat_normalize(cand[:, :4]), cand[:, 4:]], dim=1)
        if sync is not None:
            cand = sync(cand)
        new = float(system(cand, False)[2])
        if new < cur:
            thetas, cur = cand, new
            lam = max(lam * 0.5, 1e-6)
        else:
            lam = min(lam * 4.0, 1e3)
        costs.append(cur)
    return thetas, costs


def sharded_system(mesh, arrays, system_of):
    """(``system``, ``sync``) of `gauss_newton` over ``mesh``: ``arrays``
    (numpy, M rows each) padded with zeros to a multiple of the mesh size
    and split contiguously over its first axis; ``system_of(local arrays)``
    gives this rank's ``system(thetas, with_system)``, whose H, g and cost
    are summed over the axis; ``sync`` takes rank 0's candidate."""
    from ..parallel.comm import all_reduce, broadcast
    from ..parallel.mesh import axis_group, axis_names, axis_rank, axis_size
    axis = axis_names(mesh)[0]
    group = axis_group(mesh, axis)
    w, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    m = arrays[0].shape[0]
    pad = (-m) % int(mesh.size())
    per = (m + pad) // w
    local = [np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
             [r * per:(r + 1) * per] for a in arrays]
    part = system_of(local)

    def system(thetas, full):
        H, g, cost = part(thetas, full)
        if full:
            H, g = all_reduce(H, group), all_reduce(g, group)
        return H, g, all_reduce(cost, group)

    return system, lambda cand: broadcast(cand, group)


def thetas_to_numpy(thetas) -> Tuple[np.ndarray, np.ndarray]:
    """(C, 8) packed params -> (cam2w (C, 4, 4), focals (C,)) as numpy."""
    c = thetas.shape[0]
    R = quat_to_rotmat(quat_normalize(thetas[:, :4]))
    out = np.tile(np.eye(4, dtype=np.float32)[None], (c, 1, 1))
    out[:, :3, :3] = R.cpu().numpy()
    out[:, :3, 3] = thetas[:, 4:7].cpu().numpy()
    return out, np.exp(thetas[:, 7].cpu().numpy())


def lm_refine(
    cam2w: np.ndarray,
    focals: np.ndarray,
    pps: np.ndarray,
    depths: np.ndarray,
    core_pix: np.ndarray,
    corr_img1: np.ndarray,
    corr_idx1: np.ndarray,
    corr_img2: np.ndarray,
    corr_idx2: np.ndarray,
    corr_conf: np.ndarray,
    iters: int = 10,
    damping: float = 1e-3,
    mesh=None,
    opt_focal: bool = True,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, list]:
    """Damped Gauss–Newton refinement of absolute poses (and focals) on
    ``device`` (the card unless "cpu").

    cam2w (C, 4, 4), focals (C,), pps (C, 2) pixel principal points,
    depths (C, S) fixed metric core depth, core_pix (S, 2), correspondence
    arrays (M,) (conf already holds the matching and freeze masks; zeros
    are ignored). ``mesh``: the correspondences sharded over its first
    axis (module docstring). Returns (cam2w', focals', the cost after each
    iteration)."""
    dev = resolve_device(device)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)
    state = chain_to_absolute(f32(cam2w), f32(focals))
    thetas = torch.cat([state.quats, state.trans,
                        state.log_focals[:, None]], dim=1)   # (C, 8)
    fixed = (f32(core_pix), f32(pps), f32(depths))

    def system_of(corr):
        data = (*(i64(a) for a in corr[:4]), f32(corr[4]), *fixed)
        return lambda th, full: _normal_eqs(th, *data, with_system=full)

    corr = [np.asarray(a, np.int32) for a in
            (corr_img1, corr_idx1, corr_img2, corr_idx2)] \
        + [np.asarray(corr_conf, np.float32)]
    if mesh is None:
        system, sync = system_of(corr), None
    else:
        system, sync = sharded_system(mesh, corr, system_of)
    thetas, costs = gauss_newton(thetas, system, iters, damping, opt_focal,
                                 sync)
    out, focals_out = thetas_to_numpy(thetas)
    return out, focals_out, costs
