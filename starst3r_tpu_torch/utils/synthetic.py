"""Synthetic planted-pose scenes for quality measurement (port of
`starst3r_tpu/utils/synthetic.py`; numpy, bit for bit the JAX module's
arrays).

Cameras on an arc observe a known sphere; correspondences are geometrically
exact up to core-grid snapping (~1 px), so `run_global_alignment` must
recover the trajectory to a tight ATE bound: a subtly wrong GA (a sign
error, a reversed chain, a bad reparameterisation) cannot. The GA
ground-truth checks, the turntable example and chip_smoke.py's
`[planted-ga]` and `[turntable]` phases use them.
"""

from __future__ import annotations

import numpy as np

from ..alignment.condense import CondensedData
from ..ops.matching import subsample_grid_indices

__all__ = ("synthetic_ga_scene", "synthetic_image_scene")


def _look_at_poses(n):
    """Cameras on an arc with real baseline, all facing the sphere (+z)."""
    c2w = []
    for k in range(n):
        ang = (k - (n - 1) / 2) * 0.25
        off = np.array([1.2 * np.sin(ang), 0.25 * k,
                        0.5 * (1 - np.cos(ang))])
        ry = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
        m = np.eye(4)
        m[:3, :3] = ry
        m[:3, 3] = off
        c2w.append(m)
    return np.stack(c2w)


def _orbit_poses(n, sph_c, radius=4.0, spread=0.35):
    """Look-at cameras on an arc of ``radius`` around the sphere center —
    every view FRAMES the full sphere (unlike `_look_at_poses`, whose
    rotation overshoots its translation so each view clips the sphere to
    a crescent; fine for GA correspondences, fatal for a novel-view gate
    where train views must jointly cover the held-out view)."""
    c2w = []
    for k in range(n):
        th = (k - (n - 1) / 2) * spread
        # y stays within ~±0.6 regardless of n so every camera still
        # frames the sphere (±0.3*(n-1)/2 pushed 10-camera rigs' end
        # views half off-target)
        pos = sph_c + np.array([radius * np.sin(th),
                                1.2 * (k - (n - 1) / 2) / max(n - 1, 1),
                                -radius * np.cos(th)])
        f = sph_c - pos
        f = f / np.linalg.norm(f)
        r = np.cross([0.0, 1.0, 0.0], f)
        r = r / np.linalg.norm(r)
        u = np.cross(f, r)
        m = np.eye(4)
        m[:3, 0] = r
        m[:3, 1] = u
        m[:3, 2] = f
        m[:3, 3] = pos
        c2w.append(m)
    return np.stack(c2w)


def _ray_sphere_depth(c2w, K, pix, sph_c, sph_r):
    """Depth along camera z of the first ray-sphere intersection."""
    d_cam = np.stack([(pix[:, 0] - K[0, 2]) / K[0, 0],
                      (pix[:, 1] - K[1, 2]) / K[1, 1],
                      np.ones(len(pix))], -1)
    d_w = d_cam @ c2w[:3, :3].T
    o = c2w[:3, 3]
    oc = o - sph_c
    b = (d_w * oc).sum(-1)
    cterm = (oc * oc).sum() - sph_r ** 2
    a = (d_w * d_w).sum(-1)
    disc = np.maximum(b * b - a * cterm, 1e-9)
    return (-b - np.sqrt(disc)) / a


def _project(c2w, K, X):
    R = c2w[:3, :3].T
    t = -R @ c2w[:3, 3]
    cam = X @ R.T + t
    z = cam[:, 2]
    u = K[0, 0] * cam[:, 0] / z + K[0, 2]
    v = K[1, 1] * cam[:, 1] / z + K[1, 2]
    return np.stack([u, v], -1), z


def synthetic_ga_scene(n_cams: int = 4, hw: int = 128, focal: float = 180.0,
                       subsample: int = 4, focal_error: float = 0.0,
                       snap_free: bool = False, anchored: bool = False,
                       orbit: bool = False, sph_r: float = 2.0,
                       spread: float = 0.35):
    """Planted multi-view scene on a sphere (curved — no planar SfM
    degeneracy).

    Returns (data: CondensedData, mst: (root, edges), gt_c2w (C,4,4),
    K (3,3)). With ``snap_free=False`` the construction's only noise is
    core-grid snapping of the matched endpoint (~subsample/2 px), the same
    quantization the subsample-grid matcher has. ``snap_free=True`` uses
    the GA's anchored continuous endpoints (corr_pix2 at the EXACT
    projection, corr_doff2 the exact depth ratio to the anchor cell —
    the reference's make_pts3d anchor mechanism, call-site
    reconstruct.py:380), making every correspondence residual exactly zero
    at the planted poses: the GA must recover them to ATE << 1%.
    ``anchored=True`` models the PRODUCT anchor_refine path
    (ops.matching.refine_matches hard-argmax): endpoints at integer-pixel
    accuracy (round of the exact projection — the 0.5 px quantum of
    full-res refinement) with the depth offset evaluated at that integer
    pixel, anchored to the pixel's own core cell.
    """
    h = w = hw
    sph_c = np.array([0.0, 0.0, 4.0])
    gt = (_orbit_poses(n_cams, sph_c, spread=spread) if orbit
          else _look_at_poses(n_cams))
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    grid, hs, ws = subsample_grid_indices(h, w, subsample)
    grid = grid.numpy()
    s = grid.shape[0]
    core_pix = np.stack([grid % w, grid // w], -1).astype(np.float64)
    depths = np.stack([_ray_sphere_depth(gt[i], K, core_pix, sph_c, sph_r)
                       for i in range(n_cams)])
    pts = []
    for i in range(n_cams):
        dc = np.stack([(core_pix[:, 0] - K[0, 2]) / K[0, 0] * depths[i],
                       (core_pix[:, 1] - K[1, 2]) / K[1, 1] * depths[i],
                       depths[i]], -1)
        pts.append(dc @ gt[i][:3, :3].T + gt[i][:3, 3])
    pts = np.stack(pts)

    pairs = [(i, j) for i in range(n_cams) for j in range(n_cams) if i != j]
    p = len(pairs)
    ci1 = np.zeros((p, s), np.int32)
    cx1 = np.zeros((p, s), np.int32)
    ci2 = np.zeros((p, s), np.int32)
    cx2 = np.zeros((p, s), np.int32)
    cc = np.zeros((p, s), np.float32)
    cp = np.zeros((p, s), np.int32)
    cpix2 = np.zeros((p, s, 2), np.float32)
    cdoff2 = np.ones((p, s), np.float32)
    for k, (i, j) in enumerate(pairs):
        uv, z = _project(gt[j], K, pts[i])
        gx = np.clip(np.round((uv[:, 0] - subsample // 2) / subsample),
                     0, ws - 1)
        gy = np.clip(np.round((uv[:, 1] - subsample // 2) / subsample),
                     0, hs - 1)
        idx2 = (gy * ws + gx).astype(np.int32)
        inside = ((uv[:, 0] > 1) & (uv[:, 0] < w - 2) & (uv[:, 1] > 1)
                  & (uv[:, 1] < h - 2) & (z > 0.1))
        ci1[k] = i
        cx1[k] = np.arange(s)
        ci2[k] = j
        cx2[k] = idx2
        cc[k] = inside.astype(np.float32)
        cp[k] = k
        if snap_free:
            # anchored continuous endpoint: ray through the exact
            # projection, depth = anchor-cell core depth * exact ratio
            cpix2[k] = uv.astype(np.float32)
            cdoff2[k] = (z / depths[j][idx2]).astype(np.float32)
        elif anchored:
            # product-path model: integer-pixel endpoint (hard-argmax
            # refinement), depth ratio at that pixel, re-anchored to the
            # pixel's own core cell
            uv_px = np.round(uv)
            gx2 = np.clip(np.round((uv_px[:, 0] - subsample // 2)
                                   / subsample), 0, ws - 1)
            gy2 = np.clip(np.round((uv_px[:, 1] - subsample // 2)
                                   / subsample), 0, hs - 1)
            idx2p = (gy2 * ws + gx2).astype(np.int32)
            cx2[k] = idx2p
            zp = _ray_sphere_depth(gt[j], K, uv_px, sph_c, sph_r)
            cpix2[k] = uv_px.astype(np.float32)
            cdoff2[k] = (zp / depths[j][idx2p]).astype(np.float32)

    med = np.median(depths, axis=1)
    data = CondensedData(
        imsizes=np.tile(np.array([[w, h]], np.float32), (n_cams, 1)),
        pps=np.tile(np.array([[0.5, 0.5]], np.float32), (n_cams, 1)),
        base_focals=np.full(n_cams, focal * (1 + focal_error), np.float32),
        core_depth=(depths / med[:, None]).astype(np.float32),
        median_depths=med.astype(np.float32),
        core_pix=core_pix.astype(np.float32),
        corr_img1=ci1.reshape(-1), corr_idx1=cx1.reshape(-1),
        corr_img2=ci2.reshape(-1), corr_idx2=cx2.reshape(-1),
        corr_conf=cc.reshape(-1), corr_pair=cp.reshape(-1),
        pair_img1=np.array([a for a, _ in pairs], np.int32),
        pair_img2=np.array([b for _, b in pairs], np.int32),
        pair_matching_ok=np.ones(p, bool),
        preds21_pts=np.zeros((p, s, 3), np.float32),
        preds21_conf=np.zeros((p, s), np.float32),
        corr_pix2=(cpix2.reshape(-1, 2) if (snap_free or anchored)
                   else None),
        corr_doff2=(cdoff2.reshape(-1) if (snap_free or anchored)
                    else None),
    )
    mst = (0, [(i, i + 1) for i in range(n_cams - 1)])
    return data, mst, gt, K


def _sphere_texture(p: np.ndarray) -> np.ndarray:
    """Smooth RGB texture over 3D surface points p (..., 3) -> [0,1]."""
    freq = np.array([[2.1, 0.7, 1.3], [0.5, 2.7, 1.1], [1.7, 1.2, 2.3]])
    phase = np.array([0.0, 1.9, 4.2])
    return 0.5 + 0.45 * np.sin(p @ freq.T + phase)


def synthetic_image_scene(n_cams: int = 6, hw: int = 128,
                          focal: float = 180.0, subsample: int = 2,
                          sph_r: float = 1.2, spread: float = 0.35):
    """Planted scene WITH ground-truth images: the end-to-end image-space
    quality check (novel-view PSNR).

    Renders each camera's view of the textured sphere analytically
    (per-pixel ray-sphere intersection; background = black, matching an
    empty splat render), alongside the exact (snap-free) condensed GA data
    of the same scene. A full geometry+splat pipeline — GA recovers poses
    and core points, 3DGS trains against the images on the RECOVERED poses
    — must reproduce a held-out camera's image to high PSNR; the network is
    deliberately bypassed so the gate measures the framework, not a
    random-init checkpoint (reference de-facto spec: main.py:46-88).

    Returns (data, mst, gt_c2w, K, images (C,H,W,3) float [0,1],
    core_hit (C,S) bool — True where the core-grid ray intersects the
    sphere). Core cells whose ray MISSES the surface still carry a
    (clamped, tangent-shell) depth in ``data.core_depth`` — exactly like
    low-confidence sky/background pixels in a real MASt3R pointmap. A
    splat stage must seed Gaussians only from hit cells, the analog of the
    product's dense-point confidence filter (Scene conf_thres, reference
    scene.py:101,148-155); seeding the misses plants opaque
    background-colored Gaussians that occlude the true surface.
    """
    data, mst, gt, K = synthetic_ga_scene(
        n_cams=n_cams, hw=hw, focal=focal, subsample=subsample,
        snap_free=True, orbit=True, sph_r=sph_r, spread=spread)
    h = w = hw
    sph_c = np.array([0.0, 0.0, 4.0])
    core = np.asarray(data.core_pix, np.float64)
    core_hit = np.zeros((n_cams, core.shape[0]), bool)
    for i in range(n_cams):
        d_cam = np.stack([(core[:, 0] - K[0, 2]) / K[0, 0],
                          (core[:, 1] - K[1, 2]) / K[1, 1],
                          np.ones(len(core))], -1)
        d_w = d_cam @ gt[i][:3, :3].T
        oc = gt[i][:3, 3] - sph_c
        b = (d_w * oc).sum(-1)
        cterm = (oc * oc).sum() - sph_r ** 2
        a = (d_w * d_w).sum(-1)
        core_hit[i] = (b * b - a * cterm) > 0
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    pix = np.stack([u.ravel(), v.ravel()], -1)
    images = np.zeros((n_cams, h, w, 3), np.float32)
    for i in range(n_cams):
        d_cam = np.stack([(pix[:, 0] - K[0, 2]) / K[0, 0],
                          (pix[:, 1] - K[1, 2]) / K[1, 1],
                          np.ones(len(pix))], -1)
        d_w = d_cam @ gt[i][:3, :3].T
        o = gt[i][:3, 3]
        oc = o - sph_c
        b = (d_w * oc).sum(-1)
        cterm = (oc * oc).sum() - sph_r ** 2
        a = (d_w * d_w).sum(-1)
        disc = b * b - a * cterm
        hit = disc > 0
        t = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        surf = o + d_w * t[:, None]
        col = np.clip(_sphere_texture(surf), 0.0, 1.0)
        img = np.where(hit[:, None] & (t[:, None] > 0.1), col, 0.0)
        images[i] = img.reshape(h, w, 3).astype(np.float32)
    return data, mst, gt, K, images, core_hit
