"""Synthetic inputs made from the seed: photos for reconstruction, and a
textured scene with its ground-truth views and dense points for 3DGS.

`make_views` is copied from `chip_smoke.py::make_views` (a coloured 3D
point grid seen from a camera that turns about the vertical axis). The
ray-sphere intersection, the orbit of look-at cameras and the smooth
texture are copied from `starst3r_tpu_torch/utils/synthetic.py`
(`_ray_sphere_depth`'s algebra, `_orbit_poses`, `_sphere_texture`); the
textured backdrop behind the sphere is this module's own."""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def make_views(n: int, hw, seed: int = 0, n_points: int = 4000,
               turn: float = 0.06) -> List[np.ndarray]:
    """n views of a coloured 3D point grid seen from a camera that turns
    about the vertical axis, as (3, h, w) images in [-1, 1]. ``hw`` is
    (h, w); the focal is 0.8 w and the principal point the image centre."""
    h, w = hw
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, size=(n_points, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    cols = rng.uniform(0.2, 1.0, size=(n_points, 3)).astype(np.float32)
    views = []
    for k in range(n):
        ang = turn * (k - n / 2)
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        p = pts @ R.T
        img = np.full((h, w, 3), 0.12, np.float32)
        f = w * 0.8
        u = (f * p[:, 0] / p[:, 2] + w / 2).astype(int)
        v = (f * p[:, 1] / p[:, 2] + h / 2).astype(int)
        ok = (u >= 1) & (u < w - 1) & (v >= 1) & (v < h - 1)
        far_first = np.argsort(-p[:, 2])
        ok = ok[far_first]
        uu, vv, cc = u[far_first][ok], v[far_first][ok], cols[far_first][ok]
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                img[vv + dv, uu + du] = cc
        views.append(np.ascontiguousarray(
            (img * 2.0 - 1.0).transpose(2, 0, 1)))
    return views


def to_uint8(img: np.ndarray) -> np.ndarray:
    """(3, H, W) in [-1, 1] -> (H, W, 3) uint8."""
    arr = np.asarray(img).transpose(1, 2, 0) * 0.5 + 0.5
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_pngs(views: Sequence[np.ndarray], directory: Path,
               stem: str) -> List[Path]:
    from PIL import Image
    directory.mkdir(parents=True, exist_ok=True)
    paths = []
    for k, v in enumerate(views):
        p = directory / f"{stem}_{k:02d}.png"
        Image.fromarray(to_uint8(v)).save(p, compress_level=1)
        paths.append(p)
    return paths


# -- the 3DGS scene ----------------------------------------------------------

SPHERE_C = np.array([0.0, 0.0, 4.0])


def texture(p: np.ndarray, shift=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Smooth RGB texture over 3D surface points p (..., 3) -> [0, 1];
    ``shift`` moves each channel's phase."""
    freq = np.array([[2.1, 0.7, 1.3], [0.5, 2.7, 1.1], [1.7, 1.2, 2.3]])
    phase = np.array([0.0, 1.9, 4.2]) + np.asarray(shift)
    return 0.5 + 0.45 * np.sin(p @ freq.T + phase)


def look_at(pos: np.ndarray, target: np.ndarray) -> np.ndarray:
    """cam2w (4, 4) of a camera at ``pos`` facing ``target`` (+z forward,
    +y down the image)."""
    f = target - pos
    f = f / np.linalg.norm(f)
    r = np.cross([0.0, 1.0, 0.0], f)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = r, u, f, pos
    return m


def orbit_pose(theta: float, height: float, radius: float = 4.0
               ) -> np.ndarray:
    pos = SPHERE_C + np.array([radius * np.sin(theta), height,
                               -radius * np.cos(theta)])
    return look_at(pos, SPHERE_C)


def train_cameras(n: int, spread: float = 0.35) -> np.ndarray:
    """cam2w (n, 4, 4) on an arc around the sphere, every view framing it."""
    return np.stack([orbit_pose((k - (n - 1) / 2) * spread,
                                1.2 * (k - (n - 1) / 2) / max(n - 1, 1))
                     for k in range(n)])


def intrinsics(hw: Tuple[int, int], focal_frac: float) -> np.ndarray:
    h, w = hw
    f = focal_frac * w
    return np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float64)


def cast_rays(c2w: np.ndarray, K: np.ndarray, hw: Tuple[int, int],
              sph_r: float, backdrop: float, shift=(0.0, 0.0, 0.0)
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Every pixel's first surface: the sphere of radius ``sph_r`` at
    SPHERE_C, else the backdrop, a plane ``backdrop`` behind the sphere's
    centre facing this camera's mean direction. Returns (points (H*W, 3),
    colours (H*W, 3)) in raster order."""
    h, w = hw
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    d_cam = np.stack([(u.ravel() - K[0, 2]) / K[0, 0],
                      (v.ravel() - K[1, 2]) / K[1, 1],
                      np.ones(h * w)], -1)
    d = d_cam @ c2w[:3, :3].T
    o = c2w[:3, 3]
    oc = o - SPHERE_C
    b = (d * oc).sum(-1)
    cterm = (oc * oc).sum() - sph_r ** 2
    a = (d * d).sum(-1)
    disc = b * b - a * cterm
    hit = disc > 0
    t_s = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
    # backdrop: the plane through SPHERE_C + backdrop * n, normal n
    n = SPHERE_C - o
    n = n / np.linalg.norm(n)
    p0 = SPHERE_C + backdrop * n
    t_b = ((p0 - o) @ n) / (d @ n)
    t = np.where(hit & (t_s > 0.1), t_s, t_b)
    pts = o + d * t[:, None]
    return pts, np.clip(texture(pts, shift), 0.0, 1.0)


def splat_scene(n_cams: int, hw: Tuple[int, int], focal_frac: float,
                sph_r: float, backdrop: float, spread: float,
                shift=(0.0, 0.0, 0.0)):
    """The training scene: (points (C*H*W, 3) float32, colours float32,
    ground-truth views (C, H, W, 3) float32, w2c (C, 4, 4) float32, K (C, 3,
    3) float32). One point a pixel of every view; ``shift`` (from the
    seed) moves the texture's phases, so the sizes stay the same."""
    h, w = hw
    c2w = train_cameras(n_cams, spread)
    K = intrinsics(hw, focal_frac)
    pts, cols = [], []
    for c in range(n_cams):
        p, col = cast_rays(c2w[c], K, hw, sph_r, backdrop, shift)
        pts.append(p)
        cols.append(col)
    pts = np.concatenate(pts).astype(np.float32)
    cols = np.concatenate(cols).astype(np.float32)
    views = cols.reshape(n_cams, h, w, 3).astype(np.float32)
    w2c = np.linalg.inv(c2w).astype(np.float32)
    Ks = np.repeat(K[None], n_cams, 0).astype(np.float32)
    return pts, cols, views, w2c, Ks


def orbit_views(n: int, spread: float, n_train: int) -> np.ndarray:
    """w2c (n, 4, 4) of novel views spread over the training cameras' arc
    and heights, between and beside them (not on them)."""
    span = spread * (n_train - 1) / 2
    out = []
    for k in range(n):
        a = (k + 0.5) / n
        theta = -span + 2 * span * a
        height = 0.6 * np.sin(2 * np.pi * a * 3)
        out.append(np.linalg.inv(orbit_pose(theta, height)))
    return np.stack(out).astype(np.float32)
