"""Canonical per-image data from pairwise predictions (port of
`starst3r_tpu/alignment/canonical.py`; reference call-site
reconstruct.py:101-102 `prepare_canonical_data(mode='avg-angle')`).

Per image: the confidence-weighted average of every prediction of that image
in its own frame, a base focal and principal point, the avg-angle canonical
depth, and ratio anchors from the core (subsampled) grid to full resolution;
plus the cross predictions `preds_21` on the core grid for the dust3r
fallback loss. Reductions run in torch on the predictions' device; the
per-image results are host-side numpy, as in the JAX package.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models.mast3r import PairPrediction
from ..ops.matching import subsample_grid_indices
from ..utils.camera import estimate_focal_from_pointmap

__all__ = ("CanonicalView", "build_canonical_views", "compute_anchors")


@dataclass
class CanonicalView:
    """Canonical (own-frame) geometry for one image."""

    pts3d: np.ndarray       # (H, W, 3) canonical pointmap, own camera frame
    conf: np.ndarray        # (H, W) aggregated confidence
    depth: np.ndarray       # (H, W)
    focal: float            # base focal estimate (pixels)
    pp: np.ndarray          # (2,) principal point (pixels) = image center
    core_depth: np.ndarray  # (hs*ws,) canonical depth on the anchor grid
    anchor_idx: np.ndarray  # (H*W,) int32 core index for each dense pixel
    anchor_offset: np.ndarray  # (H*W,) float32 dense/core depth ratio


def _weighted_average(pts_stack: torch.Tensor, conf_stack: torch.Tensor):
    """pts_stack (P, H, W, 3), conf_stack (P, H, W) -> canonical pts/conf.
    Weights conf - 0.999; the aggregated confidence is sum(w^2)/sum(w)
    shifted back onto the 1 + exp(raw) scale."""
    w = torch.clamp(conf_stack - 0.999, min=1e-8)[..., None]
    wsum = torch.clamp(torch.sum(w, dim=0), min=1e-8)
    pts = torch.sum(pts_stack * w, dim=0) / wsum
    conf = 0.999 + torch.sum(w[..., 0] ** 2, dim=0) / wsum[..., 0]
    return pts, conf


def _avg_angle_depth(pts_stack: torch.Tensor, conf_stack: torch.Tensor,
                     subsample: int) -> torch.Tensor:
    """mode='avg-angle' canonical depth: each pixel's depth relative to its
    anchor-block centre as an elevation angle arctan((d - d_c) / r_xy),
    confidence-averaged over predictions, converted back with the mean
    radius around the mean centre depth. H, W divisible by subsample."""
    s = subsample
    off = s // 2
    w = torch.clamp(conf_stack - 0.999, min=1e-8)
    depth = pts_stack[..., 2]
    xy = pts_stack[..., :2]
    ctr_xy = xy[:, off::s, off::s, :]
    ctr_d = depth[:, off::s, off::s]
    ctr_xy_d = ctr_xy.repeat_interleave(s, 1).repeat_interleave(s, 2)
    ctr_d_d = ctr_d.repeat_interleave(s, 1).repeat_interleave(s, 2)
    radius = torch.clamp(torch.linalg.norm(xy - ctr_xy_d, dim=-1), min=1e-8)
    angle = torch.arctan((depth - ctr_d_d) / radius)
    avg_angle = torch.sum(w * angle, dim=0) / torch.clamp(
        torch.sum(w, dim=0), min=1e-8)
    return ctr_d_d.mean(0) + radius.mean(0) * torch.tan(avg_angle)


def compute_anchors(depth: np.ndarray, subsample: int):
    """Ratio anchors from a dense depth map (H, W): (core_depth (hs*ws,),
    anchor_idx (H*W,), offset (H*W,)) with dense = core[anchor_idx] * offset.
    """
    h, w = depth.shape
    grid, hs, ws = subsample_grid_indices(h, w, subsample)
    grid = grid.numpy()
    core = depth.reshape(-1)[grid]
    off = subsample // 2
    ys = np.arange(h)
    xs = np.arange(w)
    # np.round is half-to-even, as jnp.round / torch.round
    cy = np.clip(np.round((ys - off) / subsample).astype(np.int64), 0, hs - 1)
    cx = np.clip(np.round((xs - off) / subsample).astype(np.int64), 0, ws - 1)
    anchor_idx = (cy[:, None] * ws + cx[None, :]).reshape(-1).astype(np.int32)
    offset = depth.reshape(-1) / np.maximum(core[anchor_idx], 1e-8)
    return core.astype(np.float32), anchor_idx, offset.astype(np.float32)


def build_canonical_views(
    n_images: int,
    preds: Sequence[PairPrediction],
    subsample: int = 8,
    mode: str = "avg-angle",
) -> Tuple[List[CanonicalView],
           Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]]:
    """Aggregate pairwise predictions into canonical views.

    ``mode``: 'avg-angle' (reference default) or 'conf'; avg-angle falls
    back to 'conf', with a warning, when H or W is not divisible by
    subsample. Returns (views, preds_21) where preds_21[(j, i)] = (pts
    (hs*ws, 3), confs (hs*ws,)): image i's points predicted in image j's
    frame on the core grid.
    """
    h, w = preds[0].pts1.shape[:2]
    dev = preds[0].pts1.device
    grid, _, _ = subsample_grid_indices(h, w, subsample, dev)

    per_image_pts: List[List[torch.Tensor]] = [[] for _ in range(n_images)]
    per_image_conf: List[List[torch.Tensor]] = [[] for _ in range(n_images)]
    preds_21: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
    for p in preds:
        per_image_pts[p.idx1].append(p.pts1)
        per_image_conf[p.idx1].append(p.conf1)
        preds_21[(p.idx1, p.idx2)] = (
            p.pts2.reshape(-1, 3)[grid].float().cpu().numpy(),
            p.conf2.reshape(-1)[grid].float().cpu().numpy())

    views: List[CanonicalView] = []
    diag = float(np.hypot(h, w))
    for i in range(n_images):
        if not per_image_pts[i]:
            raise ValueError(f"image {i} appears in no pair as view 1")
        pts_stack = torch.stack(per_image_pts[i]).float()
        conf_stack = torch.stack(per_image_conf[i]).float()
        pts, conf = _weighted_average(pts_stack, conf_stack)
        pp = np.array([w / 2.0, h / 2.0], np.float32)
        focal = float(estimate_focal_from_pointmap(
            pts, torch.as_tensor(pp, device=dev), conf))
        # guard degenerate focals (random-init nets)
        focal = float(np.clip(focal, 0.25 * diag, 10.0 * diag))
        if mode == "avg-angle" and h % subsample == 0 and w % subsample == 0:
            depth = _avg_angle_depth(pts_stack, conf_stack, subsample)
        else:
            if mode == "avg-angle" and i == 0:
                warnings.warn(
                    f"avg-angle canonicalization needs H,W divisible by "
                    f"subsample={subsample} (got {h}x{w}); falling back "
                    f"to confidence-weighted z-averaging ('conf' mode)",
                    RuntimeWarning, stacklevel=2)
            depth = pts[..., 2]
        depth = np.maximum(depth.cpu().numpy(), 1e-6)
        core, anchor_idx, offset = compute_anchors(depth, subsample)
        views.append(CanonicalView(
            pts3d=pts.cpu().numpy(), conf=conf.cpu().numpy(), depth=depth,
            focal=focal, pp=pp, core_depth=core, anchor_idx=anchor_idx,
            anchor_offset=offset))
    return views, preds_21
