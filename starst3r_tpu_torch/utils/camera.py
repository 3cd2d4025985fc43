"""Pinhole camera math on torch tensors (port of
`starst3r_tpu/utils/camera.py`): intrinsics, the pixel grid, projection,
unprojection, the focal estimate from a pointmap, and the rigid motion
between two point sets. The functions take leading batch dimensions and
work on the device of their inputs."""

from __future__ import annotations

import torch

__all__ = ("make_intrinsics", "pixel_grid", "unproject_depth",
           "project_points", "reproj2d", "least_squares_focal",
           "estimate_focal_from_pointmap", "rigid_procrustes")


def make_intrinsics(focal, pp, dtype=torch.float32, device=None):
    """focal (...,) or (..., 1); pp (..., 2) in pixels -> K (..., 3, 3) on
    ``device`` (the inputs' device when they are tensors and it is None)."""
    if device is None and isinstance(focal, torch.Tensor):
        device = focal.device
    focal = torch.as_tensor(focal, dtype=dtype, device=device)
    if focal.ndim and focal.shape[-1] == 1:
        focal = focal[..., 0]
    pp = torch.as_tensor(pp, dtype=dtype, device=focal.device)
    K = torch.zeros(focal.shape + (3, 3), dtype=dtype, device=focal.device)
    K[..., 0, 0] = focal
    K[..., 1, 1] = focal
    K[..., 0, 2] = pp[..., 0]
    K[..., 1, 2] = pp[..., 1]
    K[..., 2, 2] = 1.0
    return K


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None):
    """(h*w, 2) pixel centers (x, y) in raster order."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def least_squares_focal(pts3d, pp, conf=None, eps: float = 1e-8):
    """The confidence-weighted least-squares quotient of
    `estimate_focal_from_pointmap` before its clamp, signed: sum w (u - c)
    . (X, Y) / Z over sum w |(X, Y) / Z|^2 for a camera-frame pointmap
    (H, W, 3) and principal point (2,)."""
    h, w = pts3d.shape[:2]
    pix = pixel_grid(h, w, device=pts3d.device).reshape(h, w, 2)
    du = pix - pp
    z = pts3d[..., 2:3]
    ratio = pts3d[..., :2] / torch.where(torch.abs(z) < eps,
                                         torch.full_like(z, eps), z)
    num = torch.sum(du * ratio, dim=-1)
    den = torch.sum(ratio * ratio, dim=-1)
    wgt = conf if conf is not None else torch.ones_like(num)
    return torch.sum(wgt * num) / torch.clamp(torch.sum(wgt * den), min=eps)


def estimate_focal_from_pointmap(pts3d, pp, conf=None, eps: float = 1e-8):
    """Confidence-weighted least-squares focal from a camera-frame pointmap
    (H, W, 3) and principal point (2,): u - cx = f * X / Z per pixel
    (`least_squares_focal`), at least ``eps``."""
    return torch.clamp(least_squares_focal(pts3d, pp, conf, eps), min=eps)


def rigid_procrustes(src, dst, weight, eps: float = 1e-12):
    """The weighted rigid motion (R, t) that takes ``src`` onto ``dst``:
    argmin sum_n w_n |R src_n + t - dst_n|^2 over rotations R, by Kabsch's
    SVD of the weighted cross-covariance with the determinant's sign
    corrected (no reflection). src, dst (..., N, 3), weight (..., N) ->
    R (..., 3, 3), t (..., 3); every leading index solved at once."""
    w = weight[..., None]
    total = torch.clamp(torch.sum(w, dim=-2), min=eps)       # (..., 1)
    mu_s = torch.sum(w * src, dim=-2) / total
    mu_d = torch.sum(w * dst, dim=-2) / total
    cov = torch.einsum("...ni,...nj->...ij", w * (src - mu_s[..., None, :]),
                       dst - mu_d[..., None, :])
    u, _, vh = torch.linalg.svd(cov)
    v = vh.transpose(-1, -2)
    sign = torch.sign(torch.linalg.det(v @ u.transpose(-1, -2)))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    fix = torch.ones(sign.shape + (3,), dtype=src.dtype, device=src.device)
    fix[..., 2] = sign
    rot = (v * fix[..., None, :]) @ u.transpose(-1, -2)
    trans = mu_d - torch.einsum("...ij,...j->...i", rot, mu_s)
    return rot, trans


def unproject_depth(depth, K, c2w=None, pix=None):
    """depth (..., N), K (..., 3, 3) and pixels (..., N, 2) -> camera-frame
    points (..., N, 3), or world-frame ones when ``c2w`` (..., 4, 4) is
    given."""
    if pix is None:
        raise ValueError("pix required (use pixel_grid)")
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    x = (pix[..., 0] - cx) / fx * depth
    y = (pix[..., 1] - cy) / fy * depth
    pts = torch.stack([x, y, depth], dim=-1)
    if c2w is not None:
        R = c2w[..., :3, :3]
        t = c2w[..., :3, 3]
        pts = torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]
    return pts


def project_points(pts, K, w2c=None, eps: float = 1e-8):
    """Points (..., N, 3) -> (pixel coordinates (..., N, 2), depth
    (..., N)); world-frame points when ``w2c`` is given, else camera-frame
    ones."""
    if w2c is not None:
        R = w2c[..., :3, :3]
        t = w2c[..., :3, 3]
        pts = torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]
    z = pts[..., 2]
    signed_eps = torch.where(z < 0, torch.full_like(z, -eps),
                             torch.full_like(z, eps))
    zc = torch.where(torch.abs(z) < eps, signed_eps, z)
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    u = fx * pts[..., 0] / zc + cx
    v = fy * pts[..., 1] / zc + cy
    return torch.stack([u, v], dim=-1), z


def reproj2d(proj_matrix, pts3d, eps: float = 1e-8):
    """A 3x4 projection matrix (K @ w2c[:3]) applied to (N, 3) points ->
    (N, 2) pixels (the reference helper `reproj2d`, call site
    reconstruct.py:366)."""
    homo = proj_matrix[..., :3, :3] @ pts3d[..., None]
    homo = homo[..., 0] + proj_matrix[..., :3, 3]
    z = homo[..., 2:3]
    zc = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    return homo[..., :2] / zc
