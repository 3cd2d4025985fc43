"""Tile-based 3D Gaussian Splatting rasterizer, forward half (port of
`starst3r_tpu/splat/rasterize.py`).

Semantics match `gsplat.rasterization` as the reference calls it
(reference: starster/gs.py:76-87): project -> 16x16 tile binning ->
depth-ordered front-to-back alpha compositing, scales and opacities in
linear space, SH degree <= 1, returning (rgb (C,H,W,3), alpha (C,H,W,1),
info).

  1. `project_gaussians`: all cameras at once, elementwise float32.
  2. binning: each Gaussian emits up to ``max_tiles_per_gaussian`` tile
     entries (its bbox, or a window centred on its projected mean when the
     bbox is larger; truncation counted in info["n_tiles_clipped"]). ONE
     stable sort of a packed int64 key (camera, tile, quantised depth) orders
     every camera's entries; with the entries laid out by Gaussian id, the
     stable sort breaks depth ties by id, as the JAX package's two-key sort
     does. Entries past ``max_per_tile`` are counted in info["tile_overflow"].
  3. the (tile, slot) -> attributes gather from a packed (C*N, 9) matrix
     and the compositing, in one: `splat.composite.composite_packed`. For
     CUDA tensors the hand-written forward and backward kernels stage each
     entry's row from the packed matrix through the binning's indices; the
     backward stores each slot's gradient and the row-sum kernel sums each
     row's slots in a fixed order (the JAX package's ``bw_idx`` backward),
     so training repeats bit for bit; no (C, T, K, 9) entries tensor is
     made. For CPU tensors, plain indexing and the plain compositing,
     differentiated by autograd.

`tile_entries` stops after the gather (`splat.gather.gather_entries`, the
standalone gather kernel on the card) and returns the entries, for
`splat.composite.composite_tiles`; the tests and chip_smoke.py use it.

Training reuses the binning across steps: `bin_gaussians` returns the
index structure (`Bins`) and `rasterize(..., bins=...)` projects every
step and reuses it, so every gradient stays exact and only the tile
assignment and depth order are as old as the bins.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import span
from .composite import composite_packed
from .gather import gather_entries

__all__ = ("Bins", "Projected", "bin_gaussians", "max_bbox_area",
           "pack_attributes", "project_gaussians", "quat_to_rotmat_wxyz",
           "rasterize", "sh_eval", "tile_entries")

_SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199


def quat_to_rotmat_wxyz(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions (any norm) -> (..., 3, 3) rotations."""
    q = q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True) + 1e-24)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def sh_eval(sh: torch.Tensor, dirs: torch.Tensor, degree: int
            ) -> torch.Tensor:
    """Spherical harmonics -> RGB, gsplat convention (+0.5, clipped at 0).
    sh (N, K, 3) with K >= (degree+1)^2; dirs (..., N, 3) unit vectors."""
    c = _SH_C0 * sh[:, 0]
    if degree >= 1:
        x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
        c = c + _SH_C1 * (-y * sh[:, 1] + z * sh[:, 2] - x * sh[:, 3])
    return torch.clamp(c + 0.5, min=0.0).expand(dirs.shape)


class Projected(NamedTuple):
    means2d: torch.Tensor    # (..., N, 2)
    depths: torch.Tensor     # (..., N)
    conics: torch.Tensor     # (..., N, 3) upper triangle of the inverse cov
    radii: torch.Tensor      # (..., N)
    colors: torch.Tensor     # (..., N, 3)
    opacities: torch.Tensor  # (N,)
    valid: torch.Tensor      # (..., N) bool


def project_gaussians(means, quats, scales, opacities, sh, w2c, K,
                      sh_degree: int = 1, eps2d: float = 0.3,
                      near: float = 0.01) -> Projected:
    """Project N Gaussians into cameras w2c (..., 4, 4), K (..., 3, 3)
    (one camera or a stack); outputs carry the cameras' leading dims."""
    R = w2c[..., :3, :3]
    t = w2c[..., :3, 3]
    cam_pts = torch.einsum("...ij,nj->...ni", R, means) + t[..., None, :]
    # a generous world box: runaway Gaussians would overflow the conic
    cam_pts = torch.clamp(cam_pts, -1e5, 1e5)
    z = cam_pts[..., 2]
    valid = z > near
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    zc = torch.clamp(z, min=near)
    u = fx * cam_pts[..., 0] / zc + cx
    v = fy * cam_pts[..., 1] / zc + cy
    means2d = torch.stack([u, v], -1)

    # cov2d = J W (M M^T) W^T J^T, M = R_q diag(s), elementwise
    q = quats * torch.rsqrt(torch.sum(quats * quats, -1, keepdim=True)
                            + 1e-24)
    qw, qx, qy, qz = q.unbind(-1)
    r = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
          2 * (qx * qz + qw * qy)],
         [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
          2 * (qy * qz - qw * qx)],
         [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
          1 - 2 * (qx * qx + qy * qy)]]
    s = scales.unbind(-1)
    Rc = lambda a, b: R[..., a, b, None]
    m2 = [[(Rc(a, 0) * r[0][k] + Rc(a, 1) * r[1][k] + Rc(a, 2) * r[2][k])
           * s[k] for k in range(3)] for a in range(3)]
    sig = [[sum(m2[a][k] * m2[b][k] for k in range(3)) for b in range(3)]
           for a in range(3)]
    x_, y_ = cam_pts[..., 0], cam_pts[..., 1]
    j00 = fx / zc
    j02 = -fx * x_ / (zc * zc)
    j11 = fy / zc
    j12 = -fy * y_ / (zc * zc)
    a = (j00 * j00 * sig[0][0] + 2 * j00 * j02 * sig[0][2]
         + j02 * j02 * sig[2][2]) + eps2d
    b = (j00 * j11 * sig[0][1] + j00 * j12 * sig[0][2]
         + j02 * j11 * sig[1][2] + j02 * j12 * sig[2][2])
    c = (j11 * j11 * sig[1][1] + 2 * j11 * j12 * sig[1][2]
         + j12 * j12 * sig[2][2]) + eps2d
    det = a * c - b * b
    # a Gaussian near a camera's plane far off its axis overflows a*c and
    # b*b, and det = inf - inf is NaN: the pair is invalid, as in the JAX
    # package, but a NaN divisor would turn the pair's zero cotangent into
    # NaN gradients (0 * NaN; the JAX package's compiled step folds those
    # zeros away). Such pairs divide by 1, so their (unused) conics are
    # finite and pass no gradient back.
    det_ok = torch.isfinite(det)
    det = torch.clamp(torch.where(det_ok, det, torch.ones_like(det)),
                      min=1e-12)
    conics = torch.stack([c / det, -b / det, a / det], -1)
    mid = 0.5 * (a + c)
    eig = mid + torch.sqrt(torch.clamp(mid * mid - det, min=1e-12))
    radii = torch.ceil(3.0 * torch.sqrt(eig))
    valid = valid & det_ok & (det > 1e-12) & (opacities > 1.0 / 255.0)

    cam_pos = -torch.einsum("...ji,...j->...i", R, t)
    dirs = means - cam_pos[..., None, :]
    dirs = dirs * torch.rsqrt(torch.sum(dirs * dirs, -1, keepdim=True)
                              + 1e-16)
    colors = sh_eval(sh, dirs, sh_degree)
    return Projected(means2d, z, conics, radii, colors, opacities, valid)


def _depth_bits(t_total: int) -> int:
    """Key bits for quantised depth: the tile id (0..t_total, t_total the
    invalid sentinel) takes the high bits of 31."""
    tile_bits = max(int(t_total + 1).bit_length(), 1)
    db = 31 - tile_bits
    if db < 8:
        raise ValueError(f"too many tiles ({t_total}) for the packed sort key")
    return db


def _bin_gaussians(proj: Projected, tw: int, th: int, tile: int,
                   max_tiles: int, max_per_tile: int):
    """Bin (C, N) projected Gaussians into tiles.

    Returns (gidx (C, T, K) int32 global row in the (C*N) packed
    attributes, ent_valid (C, T, K), counts (C, T) capped, overflow (C,),
    n_clipped (C,), max_count (C,) the uncapped largest tile occupancy).
    """
    cams, n = proj.depths.shape
    dev = proj.depths.device
    t_total = tw * th
    mx, my, rad = proj.means2d[..., 0], proj.means2d[..., 1], proj.radii
    tx0 = torch.clamp(torch.floor((mx - rad) / tile), 0, tw - 1).long()
    ty0 = torch.clamp(torch.floor((my - rad) / tile), 0, th - 1).long()
    tx1 = torch.clamp(torch.floor((mx + rad) / tile), 0, tw - 1).long()
    ty1 = torch.clamp(torch.floor((my + rad) / tile), 0, th - 1).long()
    bw = tx1 - tx0 + 1
    bh = ty1 - ty0 + 1
    area = bw * bh
    # truncated window: full width, max_tiles // bw rows centred on the mean
    bw_eff = torch.clamp(bw, max=max_tiles)
    bh_eff = torch.clamp(torch.minimum(bh, max_tiles // bw_eff), min=1)
    txc = torch.minimum(torch.maximum(torch.floor(mx / tile).long(), tx0),
                        tx1)
    tyc = torch.minimum(torch.maximum(torch.floor(my / tile).long(), ty0),
                        ty1)
    tx0e = torch.minimum(torch.maximum(txc - bw_eff // 2, tx0),
                         tx1 - bw_eff + 1)
    ty0e = torch.minimum(torch.maximum(tyc - bh_eff // 2, ty0),
                         ty1 - bh_eff + 1)
    area_eff = bw_eff * bh_eff

    e = torch.arange(max_tiles, device=dev)
    ex = e % bw_eff[..., None]                                # (C, N, E)
    ey = e // bw_eff[..., None]
    ok = proj.valid[..., None] & (e < area_eff[..., None])
    tile_id = torch.where(ok, (ty0e[..., None] + ey) * tw
                          + tx0e[..., None] + ex,
                          torch.full_like(ex, t_total))
    n_clipped = torch.sum(proj.valid & (area > max_tiles), dim=1)

    db = _depth_bits(t_total)
    zbits = torch.clamp(proj.depths, min=1e-30).float().view(torch.int32)
    zq = (zbits >> (31 - db)).long()                         # (C, N)
    cam = torch.arange(cams, device=dev)[:, None, None]
    key = (cam << 31) | (tile_id << db) | zq[..., None]      # (C, N, E)
    sorted_key, order = torch.sort(key.reshape(-1), stable=True)
    rows = order // max_tiles                                # cam*N + n

    tile_starts = ((torch.arange(cams, device=dev)[:, None] << 31)
                   | (torch.arange(t_total + 1, device=dev)[None] << db))
    starts = torch.searchsorted(sorted_key, tile_starts.reshape(-1))
    starts = starts.reshape(cams, t_total + 1)
    raw_counts = starts[:, 1:] - starts[:, :-1]
    counts = torch.clamp(raw_counts, max=max_per_tile)
    overflow = torch.sum(torch.clamp(raw_counts - max_per_tile, min=0), 1)
    max_count = raw_counts.max(dim=1).values

    ent = starts[:, :-1, None] + torch.arange(max_per_tile, device=dev)
    ent_valid = ent < starts[:, 1:, None]
    gidx = rows[torch.clamp(ent, max=rows.shape[0] - 1)].to(torch.int32)
    return gidx, ent_valid, counts, overflow, n_clipped, max_count


class Bins(NamedTuple):
    """The tile-binning index structure of C cameras (no gradients flow
    through it), reusable across training steps: the cameras are fixed
    and the means move little per step."""

    gidx: torch.Tensor        # (C, T, K) int32 row of the packed matrix
    ent_valid: torch.Tensor   # (C, T, K) slot occupancy
    counts: torch.Tensor      # (C, T) int32 capped per-tile entry counts
    overflow: torch.Tensor    # (C,) entries dropped by max_per_tile
    n_clipped: torch.Tensor   # (C,) Gaussians with bbox > max_tiles
    max_count: torch.Tensor   # (C,) uncapped largest tile occupancy


def _tile_grid(width: int, height: int, tile_size: int) -> Tuple[int, int]:
    return -(-width // tile_size), -(-height // tile_size)


@torch.no_grad()
def max_bbox_area(means, quats, scales, opacities, sh, viewmats, Ks,
                  width: int, height: int, tile_size: int = 16
                  ) -> torch.Tensor:
    """Largest tile-bbox area of any valid Gaussian over all cameras (0-dim
    int64): the scene's true per-Gaussian tile budget."""
    tw, th = _tile_grid(width, height, tile_size)
    proj = project_gaussians(means, quats, scales, opacities, sh, viewmats,
                             Ks, 0)
    mx, my, rad = proj.means2d[..., 0], proj.means2d[..., 1], proj.radii
    tx0 = torch.clamp(torch.floor((mx - rad) / tile_size), 0, tw - 1)
    ty0 = torch.clamp(torch.floor((my - rad) / tile_size), 0, th - 1)
    tx1 = torch.clamp(torch.floor((mx + rad) / tile_size), 0, tw - 1)
    ty1 = torch.clamp(torch.floor((my + rad) / tile_size), 0, th - 1)
    area = ((tx1 - tx0 + 1) * (ty1 - ty0 + 1)).long()
    return torch.where(proj.valid, area, torch.zeros_like(area)).max()


@torch.no_grad()
def bin_gaussians(means, quats, scales, opacities, sh, viewmats, Ks,
                  width: int, height: int, sh_degree: int = 1,
                  tile_size: int = 16, max_tiles_per_gaussian: int = 16,
                  max_per_tile: int = 1024) -> Bins:
    """Project and tile-bin all cameras, returning only the index structure
    (for `rasterize(..., bins=...)` reuse across training steps)."""
    tw, th = _tile_grid(width, height, tile_size)
    with span("raster/project"):
        proj = project_gaussians(means, quats, scales, opacities, sh,
                                 viewmats, Ks, sh_degree)
    with span("raster/binning"):
        gidx, ent_valid, counts, overflow, n_clip, max_count = \
            _bin_gaussians(proj, tw, th, tile_size, max_tiles_per_gaussian,
                           max_per_tile)
    return Bins(gidx, ent_valid, counts.to(torch.int32), overflow, n_clip,
                max_count)


def pack_attributes(proj: Projected) -> torch.Tensor:
    """The gather's table: (C*N, 9) float32 [mean x, mean y, conic a, b, c,
    r, g, b, opacity] rows, camera-major. Opacity is masked by validity
    before packing, so stale bins cannot composite a culled Gaussian."""
    op = torch.where(proj.valid, proj.opacities,
                     torch.zeros_like(proj.opacities))
    packed = torch.cat([proj.means2d, proj.conics, proj.colors,
                        op[..., None]], dim=-1)              # (C, N, 9)
    return packed.reshape(-1, 9).float().contiguous()


def _project_and_bin(means, quats, scales, opacities, sh, viewmats, Ks,
                     width: int, height: int, sh_degree: int,
                     tile_size: int, max_tiles_per_gaussian: int,
                     max_per_tile: int, bins: Optional[Bins]):
    """Project, and bin unless ``bins`` is given. Returns (packed (C*N, 9),
    gidx (C, T, K) int32, ent_valid (C, T, K), counts (C, T) int32, info
    dict), all contiguous."""
    tw, th = _tile_grid(width, height, tile_size)
    with span("raster/project"):
        proj = project_gaussians(means, quats, scales, opacities, sh,
                                 viewmats, Ks, sh_degree)
    if bins is None:
        with torch.no_grad(), span("raster/binning"):
            gidx, ent_valid, counts, overflow, n_clip, _ = _bin_gaussians(
                proj, tw, th, tile_size, max_tiles_per_gaussian,
                max_per_tile)
    else:
        gidx, ent_valid, counts, overflow, n_clip, _ = bins
    info = {"means2d": proj.means2d, "radii": proj.radii,
            "depths": proj.depths, "n_tiles_clipped": n_clip,
            "tile_overflow": overflow, "width": width, "height": height}
    with span("raster/pack"):
        packed = pack_attributes(proj)
    return (packed, gidx.contiguous(), ent_valid.contiguous(),
            counts.to(torch.int32).contiguous(), info)


def tile_entries(means, quats, scales, opacities, sh, viewmats, Ks,
                 width: int, height: int, sh_degree: int = 1,
                 tile_size: int = 16, max_tiles_per_gaussian: int = 16,
                 max_per_tile: int = 1024, bins: Optional[Bins] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Project, bin and gather: the input of `composite_tiles`. With
    ``bins`` (a `bin_gaussians` result for the same cameras and budgets)
    the binning is reused and only the projection runs. Not the
    rasterizer's path, which gathers inside the compositing kernels.

    Returns (entries (C, T, K, 9) float32 [mean x, mean y, conic a, b, c,
    r, g, b, opacity], depth-ordered per tile and zero past each tile's
    count; counts (C, T) int32; info dict)."""
    packed, gidx, ent_valid, counts, info = _project_and_bin(
        means, quats, scales, opacities, sh, viewmats, Ks, width, height,
        sh_degree, tile_size, max_tiles_per_gaussian, max_per_tile, bins)
    return gather_entries(packed, gidx, ent_valid), counts, info


def rasterize(means, quats, scales, opacities, sh, viewmats, Ks,
              width: int, height: int, sh_degree: int = 1,
              tile_size: int = 16, max_tiles_per_gaussian: int = 16,
              max_per_tile: int = 1024, chunk: int = 128,
              impl: str = "auto", bins: Optional[Bins] = None):
    """Render C cameras. means (N,3), quats (N,4) wxyz, scales (N,3) linear,
    opacities (N,) linear, sh (N,K,3), viewmats = w2c (C,4,4), Ks (C,3,3),
    all on one device. ``chunk`` only affects the plain (CPU) compositing.
    ``impl``: "auto", the port's one route (the CUDA kernels for CUDA
    tensors, their plain versions for CPU tensors); the JAX package's
    "pallas", "xla" and "ref" raise ValueError. ``bins``: an optional
    `bin_gaussians` result to reuse. Differentiable in the Gaussian
    parameters.

    Returns (rgb (C,H,W,3), alpha (C,H,W,1), info) with info["tile_overflow"]
    and info["n_tiles_clipped"] per camera."""
    if impl != "auto":
        raise ValueError(
            f"rasterize impl {impl!r}: the port has one route, 'auto' (the "
            "CUDA compositing kernels for CUDA tensors, their plain "
            "versions for CPU tensors)")
    tw, th = _tile_grid(width, height, tile_size)
    packed, gidx, _, counts, info = _project_and_bin(
        means, quats, scales, opacities, sh, viewmats, Ks, width, height,
        sh_degree, tile_size, max_tiles_per_gaussian, max_per_tile, bins)
    with span("raster/composite"):
        rgb, alpha = composite_packed(packed, gidx, counts, height, width,
                                      tile_size, tw, th,
                                      chunk=min(chunk, max_per_tile))
    return rgb, alpha[..., None], info
