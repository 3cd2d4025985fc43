"""SO(3)/SE(3) math on torch tensors (port of `starst3r_tpu/utils/se3.py`).

Quaternions are **wxyz** throughout, as in the JAX package. `interp_se3` /
`interp_se3_path` mirror the reference camera-path API
(reference: starster/utils.py:36-78): ``mode='lerp'`` lerps rotation columns
and re-orthogonalises them with a normalised Gram-Schmidt, ``mode='slerp'``
uses quaternion slerp.
"""

from __future__ import annotations

import torch

__all__ = (
    "quat_normalize",
    "quat_to_rotmat",
    "rotmat_to_quat",
    "quat_mul",
    "quat_slerp",
    "se3_from_quat_trans",
    "se3_inverse",
    "se3_compose",
    "se3_apply",
    "interp_se3",
    "interp_se3_path",
)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) (..., 4) to unit norm (rsqrt(sum + eps): the
    gradient stays finite at q = 0)."""
    return q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [w,x,y,z] -> rotation matrix (..., 3, 3)."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1)
    row1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1)
    row2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1)
    return torch.stack([row0, row1, row2], -2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [w,x,y,z].

    Branchless Shepperd: all four candidates, the one with the largest
    denominator wins."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    c0 = torch.stack([qw[..., 0], (m21 - m12) / (4 * qw[..., 0]),
                      (m02 - m20) / (4 * qw[..., 0]),
                      (m10 - m01) / (4 * qw[..., 0])], -1)
    c1 = torch.stack([(m21 - m12) / (4 * qw[..., 1]), qw[..., 1],
                      (m01 + m10) / (4 * qw[..., 1]),
                      (m02 + m20) / (4 * qw[..., 1])], -1)
    c2 = torch.stack([(m02 - m20) / (4 * qw[..., 2]),
                      (m01 + m10) / (4 * qw[..., 2]), qw[..., 2],
                      (m12 + m21) / (4 * qw[..., 2])], -1)
    c3 = torch.stack([(m10 - m01) / (4 * qw[..., 3]),
                      (m02 + m20) / (4 * qw[..., 3]),
                      (m12 + m21) / (4 * qw[..., 3]), qw[..., 3]], -1)
    cands = torch.stack([c0, c1, c2, c3], -2)           # (..., 4, 4)
    best = torch.argmax(qw, dim=-1)                      # (...,)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_normalize(q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions [w,x,y,z]."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation of unit quaternions (shortest arc)."""
    a = quat_normalize(a)
    b = quat_normalize(b)
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0, -b, b)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.where(small, torch.ones_like(sin_theta), sin_theta)
    w_a = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w_b = torch.where(small, t * torch.ones_like(theta),
                      torch.sin(t * theta) / safe)
    return quat_normalize(w_a * a + w_b * b)


def se3_from_quat_trans(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion and (..., 3) translation -> (..., 4, 4) SE3."""
    R = quat_to_rotmat(q)
    M = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    M[..., :3, :3] = R
    M[..., :3, 3] = t
    M[..., 3, 3] = 1.0
    return M


def se3_inverse(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of SE3 matrices (..., 4, 4)."""
    R = M[..., :3, :3]
    t = M[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    bottom = torch.zeros_like(M[..., 3:, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([Rt, ti[..., None]], -1), bottom], -2)


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_apply(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply SE3 (..., 4, 4) to points (..., N, 3)."""
    R = M[..., :3, :3]
    t = M[..., :3, 3]
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def _normalize_vec(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v), min=1e-12)


def interp_se3(mat1: torch.Tensor, mat2: torch.Tensor, fac,
               mode: str = "lerp") -> torch.Tensor:
    """Interpolate between two SE3 matrices (4, 4)."""
    trans = mat1[:3, 3] + (mat2[:3, 3] - mat1[:3, 3]) * fac
    if mode == "slerp":
        q = quat_slerp(rotmat_to_quat(mat1[:3, :3]),
                       rotmat_to_quat(mat2[:3, :3]), fac)
        R = quat_to_rotmat(q)
    else:
        so3 = mat1[:3, :3] + (mat2[:3, :3] - mat1[:3, :3]) * fac
        # modified Gram-Schmidt on normalised pivots: a true rotation
        c0 = _normalize_vec(so3[:, 0])
        c1 = _normalize_vec(so3[:, 1] - c0 * torch.dot(c0, so3[:, 1]))
        c2 = so3[:, 2] - c0 * torch.dot(c0, so3[:, 2])
        c2 = _normalize_vec(c2 - c1 * torch.dot(c1, c2))
        R = torch.stack([c0, c1, c2], dim=1)
    out = torch.zeros_like(mat1)
    out[:3, :3] = R
    out[:3, 3] = trans
    out[3, 3] = 1.0
    return out


def interp_se3_path(mat1, mat2, steps: int, mode: str = "lerp"
                    ) -> torch.Tensor:
    """Stack of ``steps`` interpolations with linspace factors
    (reference: starster/utils.py:57-78). Accepts tensors or arrays; returns
    a tensor on ``mat1``'s device."""
    mat1 = torch.as_tensor(mat1, dtype=torch.float32)
    mat2 = torch.as_tensor(mat2, dtype=torch.float32, device=mat1.device)
    facs = torch.linspace(0.0, 1.0, steps).tolist()
    return torch.stack([interp_se3(mat1, mat2, f, mode=mode) for f in facs])
