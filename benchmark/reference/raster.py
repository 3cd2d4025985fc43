"""Plain PyTorch reference of the tile rasterizer of 3D Gaussian Splatting
as gsplat defines it and the program configures it: EWA projection with a
0.3 px low-pass, degree-1 spherical-harmonic colours, 16 x 16 tiles, each
Gaussian in the tiles its 3-sigma box meets (at most ``max_tiles`` of
them: a window of the box about the projected mean), each tile's list in
front-to-back order of a depth key with ties in Gaussian order and at
most ``max_per_tile`` long, and front-to-back alpha compositing (alpha =
opacity exp(-sigma), sigma clipped to [0, 50], pairs with sigma < 0 or
alpha <= 1/255 skipped, alpha capped at 0.999).

Differentiable in the Gaussians' parameters (autograd), float32. Imports
nothing of the program under test."""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
BATCH = 128         # slots per compositing chunk


class Projected(NamedTuple):
    xy: torch.Tensor        # (N, 2)
    depth: torch.Tensor     # (N,)
    conic: torch.Tensor     # (N, 3) a, b, c of the inverse 2D covariance
    radius: torch.Tensor    # (N,)
    color: torch.Tensor     # (N, 3)
    opacity: torch.Tensor   # (N,)
    valid: torch.Tensor     # (N,) bool


def rotmat(q):
    q = q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True) + 1e-24)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def project(means, quats, scales, opacities, sh, w2c, K, eps2d=0.3,
            near=0.01) -> Projected:
    """One camera: w2c (4, 4), K (3, 3); scales and opacities linear."""
    R, t = w2c[:3, :3], w2c[:3, 3]
    cam = torch.clamp(means @ R.T + t, -1e5, 1e5)
    z = cam[:, 2]
    zc = torch.clamp(z, min=near)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xy = torch.stack([fx * cam[:, 0] / zc + cx, fy * cam[:, 1] / zc + cy],
                     -1)
    M = rotmat(quats) * scales[:, None, :]                  # R_q diag(s)
    cov = M @ M.transpose(1, 2)                             # world
    cov_c = R @ cov @ R.T                                   # camera
    J = torch.zeros((means.shape[0], 2, 3), dtype=means.dtype,
                    device=means.device)
    J[:, 0, 0] = fx / zc
    J[:, 0, 2] = -fx * cam[:, 0] / (zc * zc)
    J[:, 1, 1] = fy / zc
    J[:, 1, 2] = -fy * cam[:, 1] / (zc * zc)
    c2 = J @ cov_c @ J.transpose(1, 2)
    a = c2[:, 0, 0] + eps2d
    b = c2[:, 0, 1]
    c = c2[:, 1, 1] + eps2d
    det = a * c - b * b
    ok = torch.isfinite(det)
    det = torch.clamp(torch.where(ok, det, torch.ones_like(det)), min=1e-12)
    conic = torch.stack([c / det, -b / det, a / det], -1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(
        mid + torch.sqrt(torch.clamp(mid * mid - det, min=1e-12))))
    valid = (z > near) & ok & (det > 1e-12) & (opacities > 1.0 / 255.0)
    cam_pos = -(R.T @ t)
    d = means - cam_pos
    d = d * torch.rsqrt(torch.sum(d * d, -1, keepdim=True) + 1e-16)
    col = SH_C0 * sh[:, 0] + SH_C1 * (-d[:, 1:2] * sh[:, 1]
                                      + d[:, 2:3] * sh[:, 2]
                                      - d[:, 0:1] * sh[:, 3])
    return Projected(xy, z, conic, radius, torch.clamp(col + 0.5, min=0.0),
                     opacities, valid)


def tile_lists(p: Projected, w: int, h: int, tile: int, max_tiles: int,
               max_per_tile: int) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """(slots (T, K) Gaussian ids, -1 where empty; counts (T,); stats).
    No gradient flows through the lists."""
    with torch.no_grad():
        tw, th = -(-w // tile), -(-h // tile)
        n_tiles = tw * th
        x, y, r = p.xy[:, 0], p.xy[:, 1], p.radius
        fl = lambda v, hi: torch.clamp(torch.floor(v / tile), 0, hi).long()
        x0, x1 = fl(x - r, tw - 1), fl(x + r, tw - 1)
        y0, y1 = fl(y - r, th - 1), fl(y + r, th - 1)
        bw, bh = x1 - x0 + 1, y1 - y0 + 1
        ew = torch.clamp(bw, max=max_tiles)
        eh = torch.clamp(torch.minimum(bh, max_tiles // ew), min=1)
        xc = torch.minimum(torch.maximum(torch.floor(x / tile).long(), x0),
                           x1)
        yc = torch.minimum(torch.maximum(torch.floor(y / tile).long(), y0),
                           y1)
        wx0 = torch.minimum(torch.maximum(xc - ew // 2, x0), x1 - ew + 1)
        wy0 = torch.minimum(torch.maximum(yc - eh // 2, y0), y1 - eh + 1)
        e = torch.arange(max_tiles, device=x.device)
        inside = p.valid[:, None] & (e[None] < (ew * eh)[:, None])
        tid = (wy0[:, None] + e[None] // ew[:, None]) * tw \
            + wx0[:, None] + e[None] % ew[:, None]
        gid = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(
            tid)
        tid, gid = tid[inside], gid[inside]            # Gaussian-major
        # depth key: the float's top bits below the tile id's
        tile_bits = max(int(n_tiles + 1).bit_length(), 1)
        db = 31 - tile_bits
        zq = (torch.clamp(p.depth.detach(), min=1e-30).float()
              .view(torch.int32) >> (31 - db)).long()
        key = (tid << db) | zq[gid]
        order = torch.sort(key, stable=True).indices
        tid, gid = tid[order], gid[order]
        raw = torch.bincount(tid, minlength=n_tiles)
        start = torch.cumsum(raw, 0) - raw
        rank = torch.arange(tid.shape[0], device=x.device) - start[tid]
        keep = rank < max_per_tile
        k = max(int(min(int(raw.max()) if raw.numel() else 0,
                        max_per_tile)), 1)
        slots = torch.full((n_tiles, k), -1, dtype=torch.long,
                           device=x.device)
        slots[tid[keep], rank[keep]] = gid[keep]
        stats = {"max_count": int(raw.max()) if raw.numel() else 0,
                 "overflow": int(torch.clamp(raw - max_per_tile,
                                             min=0).sum()),
                 "area": int(torch.where(p.valid, bw * bh,
                                         torch.zeros_like(bw)).max())}
        return slots, torch.clamp(raw, max=max_per_tile), stats


def composite(p: Projected, slots, counts, w: int, h: int, tile: int,
              quant=None):
    """rgb (H, W, 3), alpha (H, W): each tile's list front to back.
    ``quant`` rounds the Gaussians' attributes first (a control's lower
    precision)."""
    tw, th = -(-w // tile), -(-h // tile)
    dev = p.xy.device
    pix = torch.arange(tile * tile, device=dev)
    t_ids = torch.arange(tw * th, device=dev)
    px = ((t_ids % tw)[:, None] * tile + pix % tile + 0.5).float()
    py = ((t_ids // tw)[:, None] * tile + pix // tile + 0.5).float()
    opac = torch.where(p.valid, p.opacity, torch.zeros_like(p.opacity))
    attrs = torch.cat([p.xy, p.conic, p.color, opac[:, None]], -1)
    if quant is not None:
        attrs = quant(attrs)
    zero = torch.zeros(1, 9, dtype=attrs.dtype, device=dev)
    attrs = torch.cat([attrs, zero])                   # row -1: empty slot
    rgb = torch.zeros((tw * th, tile * tile, 3), dtype=attrs.dtype,
                      device=dev)
    trans = torch.ones((tw * th, tile * tile), dtype=attrs.dtype, device=dev)
    for s in range(0, slots.shape[1], BATCH):
        act = torch.nonzero(counts > s).squeeze(1)
        if act.numel() == 0:
            break
        e = attrs[slots[act, s:s + BATCH]]              # (A, B, 9)
        dx = px[act][:, None, :] - e[:, :, 0:1]
        dy = py[act][:, None, :] - e[:, :, 1:2]
        sigma = 0.5 * (e[:, :, 2:3] * dx * dx + e[:, :, 4:5] * dy * dy) \
            + e[:, :, 3:4] * dx * dy
        alpha = e[:, :, 8:9] * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
        alpha = torch.where((sigma >= 0) & (alpha > 1.0 / 255.0),
                            torch.clamp(alpha, max=0.999),
                            torch.zeros_like(alpha))
        keep = torch.cumprod(1.0 - alpha, 1)
        before = torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], 1)
        wgt = alpha * before * trans[act][:, None, :]
        add = torch.einsum("abp,abc->apc", wgt, e[:, :, 5:8])
        rgb = rgb.index_add(0, act, add)
        trans = trans.index_copy(0, act, trans[act] * keep[:, -1])
    img = rgb.reshape(th, tw, tile, tile, 3).permute(0, 2, 1, 3, 4)
    img = img.reshape(th * tile, tw * tile, 3)[:h, :w]
    a = (1.0 - trans).reshape(th, tw, tile, tile).permute(0, 2, 1, 3)
    return img, a.reshape(th * tile, tw * tile)[:h, :w]


def render_one(g: Dict[str, torch.Tensor], w2c, K, w: int, h: int,
               tile: int, max_tiles: int, max_per_tile: int, quant=None):
    """One camera's (rgb, alpha, stats) of Gaussians ``g`` (means, quats,
    scales, opacities (linear), sh). ``quant`` rounds every input and the
    projected attributes (a control's lower precision)."""
    q = quant or (lambda t: t)
    p = project(q(g["means"]), q(g["quats"]), q(g["scales"]),
                q(g["opacities"]), q(g["sh"]), w2c, K)
    slots, counts, stats = tile_lists(p, w, h, tile, max_tiles,
                                      max_per_tile)
    rgb, alpha = composite(p, slots, counts, w, h, tile, quant)
    return rgb, alpha, stats
