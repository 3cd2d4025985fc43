"""Trajectory quality metrics (port of `starst3r_tpu/utils/eval.py`;
numpy): Umeyama alignment, ATE, relative rotation error and the
registration of a known pose into a reconstruction's frame.

Predicted trajectories are aligned to ground truth with a similarity
transform (Umeyama) before the RMSE: the GA has a global SE(3) + scale gauge
freedom (the root pose and the min-log-size pinning, reference
reconstruct.py:219-221), so raw pose differences are meaningless.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ("umeyama", "align_trajectory", "ate_rmse", "rotation_angle_deg",
           "rpe_rotation_deg", "register_pose_into")


def umeyama(src: np.ndarray, dst: np.ndarray,
            with_scale: bool = True) -> Tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity transform: dst ≈ s * R @ src + t.

    src, dst: (N, 3). Returns (s, R (3,3), t (3,)). Umeyama (1991).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def align_trajectory(pred_c2w: np.ndarray, gt_c2w: np.ndarray,
                     with_scale: bool = True) -> np.ndarray:
    """Similarity-align predicted camera-to-world poses to ground truth.

    pred_c2w, gt_c2w: (C, 4, 4). Returns aligned pred poses (C, 4, 4).
    """
    pred = np.asarray(pred_c2w, np.float64)
    gt = np.asarray(gt_c2w, np.float64)
    s, R, t = umeyama(pred[:, :3, 3], gt[:, :3, 3], with_scale)
    out = pred.copy()
    out[:, :3, 3] = (s * (R @ pred[:, :3, 3].T)).T + t
    out[:, :3, :3] = R @ pred[:, :3, :3]
    return out


def ate_rmse(pred_c2w: np.ndarray, gt_c2w: np.ndarray,
             with_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE of camera centers) after Umeyama
    similarity alignment."""
    aligned = align_trajectory(pred_c2w, gt_c2w, with_scale)
    d = aligned[:, :3, 3] - np.asarray(gt_c2w, np.float64)[:, :3, 3]
    return float(np.sqrt((d ** 2).sum(axis=1).mean()))


def rpe_rotation_deg(pred_c2w: np.ndarray, gt_c2w: np.ndarray) -> float:
    """Max pairwise relative-rotation error (degrees) — gauge-free (no
    alignment needed, unlike :func:`rotation_angle_deg` whose Umeyama
    alignment is ill-conditioned for near-collinear camera centers)."""
    pred = np.asarray(pred_c2w, np.float64)
    gt = np.asarray(gt_c2w, np.float64)
    errs = []
    for i in range(len(gt)):
        for j in range(i + 1, len(gt)):
            rp = pred[i][:3, :3].T @ pred[j][:3, :3]
            rg = gt[i][:3, :3].T @ gt[j][:3, :3]
            c = (np.trace(rp.T @ rg) - 1.0) / 2.0
            errs.append(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
    return float(np.max(errs))


def rotation_angle_deg(pred_c2w: np.ndarray, gt_c2w: np.ndarray) -> np.ndarray:
    """Per-camera rotation error (degrees) after Umeyama alignment."""
    aligned = align_trajectory(pred_c2w, gt_c2w)
    gt = np.asarray(gt_c2w, np.float64)
    rel = np.einsum("cij,ckj->cik", aligned[:, :3, :3], gt[:, :3, :3])
    tr = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return np.degrees(np.arccos(tr))


def register_pose_into(ref_gt_c2w: np.ndarray, ref_rec_c2w: np.ndarray,
                       query_gt_c2w: np.ndarray) -> np.ndarray:
    """Map an externally-known camera pose into a reconstruction's frame.

    Novel-view evaluation protocol: a reconstruction lives in its own
    SE(3)+scale gauge, so evaluating a HELD-OUT view must not pay the
    held-out camera's own pose-estimation error twice — benchmarks
    register the known eval pose into the reconstruction frame via the
    similarity transform fitted on the TRAIN cameras (Umeyama on camera
    centers), then render there.

    The rotation comes from the chordal mean of the per-camera relative
    rotations (R_rec R_gt^T) — camera CENTERS alone (Umeyama) leave the
    rotation ill-constrained when the cameras lie near an arc/line, the
    common capture geometry. Scale and translation are then least-squares
    on the centers given that rotation.

    ref_gt_c2w (N,4,4) known train poses; ref_rec_c2w (N,4,4) recovered
    train poses; query_gt_c2w (4,4) known eval pose. Returns the eval
    pose expressed in the reconstruction frame (4,4).
    """
    gt = np.asarray(ref_gt_c2w, np.float64)
    rec = np.asarray(ref_rec_c2w, np.float64)
    # chordal-mean rotation: argmax_R sum_i <R, R_rec_i R_gt_i^T>
    M = sum(rec[i, :3, :3] @ gt[i, :3, :3].T for i in range(gt.shape[0]))
    U, _, Vt = np.linalg.svd(M)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    # scale + translation on centers, rotation fixed
    src = gt[:, :3, 3] @ R.T                  # rotated GT centers
    dst = rec[:, :3, 3]
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    denom = float((xs * xs).sum())
    s = float((xs * xd).sum()) / max(denom, 1e-12)
    t = mu_d - s * mu_s
    out = np.eye(4)
    q = np.asarray(query_gt_c2w, np.float64)
    out[:3, :3] = R @ q[:3, :3]
    out[:3, 3] = s * (R @ q[:3, 3]) + t
    return out.astype(np.float32)
