"""Pinhole camera helpers on torch tensors (the part of
`starst3r_tpu/utils/camera.py` the canonical views use): the pixel grid and
the focal estimate from a pointmap."""

from __future__ import annotations

import torch

__all__ = ("pixel_grid", "estimate_focal_from_pointmap")


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None):
    """(h*w, 2) pixel centers (x, y) in raster order."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def estimate_focal_from_pointmap(pts3d, pp, conf=None, eps: float = 1e-8):
    """Confidence-weighted least-squares focal from a camera-frame pointmap
    (H, W, 3) and principal point (2,): u - cx = f * X / Z per pixel."""
    h, w = pts3d.shape[:2]
    pix = pixel_grid(h, w, device=pts3d.device).reshape(h, w, 2)
    du = pix - pp
    z = pts3d[..., 2:3]
    ratio = pts3d[..., :2] / torch.where(torch.abs(z) < eps,
                                         torch.full_like(z, eps), z)
    num = torch.sum(du * ratio, dim=-1)
    den = torch.sum(ratio * ratio, dim=-1)
    wgt = conf if conf is not None else torch.ones_like(num)
    f = torch.sum(wgt * num) / torch.clamp(torch.sum(wgt * den), min=eps)
    return torch.clamp(f, min=eps)
