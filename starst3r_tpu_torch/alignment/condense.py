"""Condense per-image / per-pair data into flat padded tensors for the GA.

The port's copy of `starst3r_tpu/alignment/condense.py` (host-side numpy).
It replaces the reference's Python slice lists (`condense_data`, reference
call-site reconstruct.py:106-107; slice structure reconstruct.py:279-309):
correspondences become fixed-size arrays with an explicit validity mask and a
pair-id column (segment ids), so every GA loss is one masked vectorized
reduction. ``matches`` hold numpy arrays (`reconstruct_scene` copies the
match tensors to the host before condensing).

Layout (S = core grid size per image, P = number of ordered pairs,
M = P * S correspondence slots):
  corr_img1/idx1/img2/idx2 (M,)  — image + core-grid indices per match slot
  corr_conf (M,)                 — 0 where invalid
  corr_pair (M,)                 — pair id (segment id)
  pair_img1/img2 (P,)            — the ordered pair list
  pair_matching_ok (P,)          — max match conf > matching_conf_thr
                                   (reference reconstruct.py:268-271)
  preds21_pts (P, S, 3) / conf   — cross predictions for the dust3r fallback:
        slot p=(i1,i2) holds image i1's points predicted in i2's frame
        (= pts2 of ordered pair (i2, i1)), matching the reference's
        preds_21[imgs[s.img2]][imgs[s.img1]] lookup (reconstruct.py:308).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..ops.matching import PairMatches, subsample_grid_indices
from .canonical import CanonicalView

__all__ = ("CondensedData", "condense")


class CondensedData(NamedTuple):
    # per-image
    imsizes: np.ndarray        # (C, 2) float32 (W, H)
    pps: np.ndarray            # (C, 2) float32 normalized principal points
    base_focals: np.ndarray    # (C,) float32
    core_depth: np.ndarray     # (C, S) float32, median-normalized
    median_depths: np.ndarray  # (C,) float32
    core_pix: np.ndarray       # (S, 2) float32 pixel coords of the core grid
    # correspondences
    corr_img1: np.ndarray      # (M,) int32
    corr_idx1: np.ndarray      # (M,) int32 (core-grid index)
    corr_img2: np.ndarray      # (M,) int32
    corr_idx2: np.ndarray      # (M,) int32
    corr_conf: np.ndarray      # (M,) float32
    corr_pair: np.ndarray      # (M,) int32
    # pairs
    pair_img1: np.ndarray      # (P,) int32
    pair_img2: np.ndarray      # (P,) int32
    pair_matching_ok: np.ndarray  # (P,) bool
    preds21_pts: np.ndarray    # (P, S, 3) float32
    preds21_conf: np.ndarray   # (P, S) float32
    # Optional anchored continuous endpoints (the reference's make_pts3d
    # anchor densification — call-site reconstruct.py:380: a correspondence
    # endpoint lives at a CONTINUOUS pixel whose depth is the core-cell
    # depth times a fixed offset, so endpoints are not snapped to the core
    # grid). None = endpoints at the core-grid pixels with offset 1
    # (the subsample-grid matching case).
    corr_pix1: Optional[np.ndarray] = None   # (M, 2) float32 pixel coords
    corr_pix2: Optional[np.ndarray] = None   # (M, 2)
    corr_doff1: Optional[np.ndarray] = None  # (M,) depth = core * doff
    corr_doff2: Optional[np.ndarray] = None  # (M,)


def condense(
    views: Sequence[CanonicalView],
    matches: Dict[Tuple[int, int], PairMatches],
    preds_21: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]],
    image_hw: Tuple[int, int],
    subsample: int,
    matching_conf_thr: float = 5.0,
    max_corres_per_pair: int = 0,
    refined: Optional[Dict[Tuple[int, int], Tuple[np.ndarray,
                                                  np.ndarray]]] = None,
) -> CondensedData:
    """``max_corres_per_pair`` > 0 caps each pair's correspondence slots:
    when the core grid is larger, only the top-confidence matches are kept
    (memory cap for high-resolution grids; 0 = keep the full grid).

    ``refined``: optional per-pair full-resolution match pixels
    (pix1 (n,2), pix2 (n,2) from ops.matching.refine_matches). When given,
    each correspondence endpoint becomes its refined CONTINUOUS pixel
    anchored to its core cell with the canonical depth offset — the
    reference's pixel-accurate anchor mechanism (make_pts3d anchors,
    call-site reconstruct.py:380) on the product path (VERDICT r3 #4:
    the snapped grid endpoints dominated GA ATE)."""
    h, w = image_hw
    grid, hs, ws = subsample_grid_indices(h, w, subsample)
    grid = grid.numpy()
    s = grid.shape[0]
    m_slots = min(s, max_corres_per_pair) if max_corres_per_pair > 0 else s
    c = len(views)
    pairs = sorted(matches.keys())
    p = len(pairs)

    imsizes = np.tile(np.array([[w, h]], np.float32), (c, 1))
    pps = np.stack([v.pp for v in views]).astype(np.float32) / imsizes
    base_focals = np.array([v.focal for v in views], np.float32)
    core_raw = np.stack([v.core_depth for v in views]).astype(np.float32)
    median_depths = np.median(core_raw, axis=1).astype(np.float32)
    core_depth = core_raw / np.maximum(median_depths[:, None], 1e-8)
    core_pix = np.stack([grid % w, grid // w], axis=-1).astype(np.float32)

    anchored = refined is not None
    corr_pix1 = np.zeros((p, m_slots, 2), np.float32) if anchored else None
    corr_pix2 = np.zeros((p, m_slots, 2), np.float32) if anchored else None
    corr_doff1 = np.zeros((p, m_slots), np.float32) if anchored else None
    corr_doff2 = np.zeros((p, m_slots), np.float32) if anchored else None
    corr_img1 = np.zeros((p, m_slots), np.int32)
    corr_idx1 = np.zeros((p, m_slots), np.int32)
    corr_img2 = np.zeros((p, m_slots), np.int32)
    corr_idx2 = np.zeros((p, m_slots), np.int32)
    corr_conf = np.zeros((p, m_slots), np.float32)
    corr_pair = np.zeros((p, m_slots), np.int32)
    pair_img1 = np.zeros(p, np.int32)
    pair_img2 = np.zeros(p, np.int32)
    pair_max_conf = np.zeros(p, np.float32)
    preds_pts = np.zeros((p, s, 3), np.float32)
    preds_conf = np.zeros((p, s), np.float32)

    for k, (i, j) in enumerate(pairs):
        m = matches[(i, j)]
        conf = np.asarray(m.conf) * np.asarray(m.mask)
        if m_slots < conf.shape[0]:
            sel = np.argpartition(conf, -m_slots)[-m_slots:]
        else:
            sel = slice(None)
        corr_img1[k] = i
        corr_idx1[k] = np.asarray(m.idx1)[sel]
        corr_img2[k] = j
        corr_idx2[k] = np.asarray(m.idx2)[sel]
        corr_conf[k] = conf[sel].astype(np.float32)
        if anchored:
            pix1, pix2 = refined[(i, j)]
            pix1 = np.asarray(pix1)[sel]
            pix2 = np.asarray(pix2)[sel]
            # re-anchor each continuous endpoint to the core cell that
            # owns its pixel; depth = core_depth[cell] * canonical offset
            for side, (vi, pix, cpix, cidx, cdoff) in enumerate((
                    (i, pix1, corr_pix1, corr_idx1, corr_doff1),
                    (j, pix2, corr_pix2, corr_idx2, corr_doff2))):
                v = views[vi]
                flat = (np.clip(pix[:, 1], 0, h - 1).astype(np.int64) * w
                        + np.clip(pix[:, 0], 0, w - 1).astype(np.int64))
                cidx[k] = np.asarray(v.anchor_idx).reshape(-1)[flat]
                cdoff[k] = np.asarray(v.anchor_offset).reshape(-1)[flat]
                cpix[k] = pix
        corr_pair[k] = k
        pair_img1[k] = i
        pair_img2[k] = j
        pair_max_conf[k] = float(conf.max()) if conf.size else 0.0
        # dust3r-fallback target: image i's pts in j's frame = pts2 of (j, i)
        if (j, i) in preds_21:
            preds_pts[k], preds_conf[k] = preds_21[(j, i)]

    return CondensedData(
        imsizes=imsizes, pps=pps, base_focals=base_focals,
        core_depth=core_depth, median_depths=median_depths, core_pix=core_pix,
        corr_img1=corr_img1.reshape(-1), corr_idx1=corr_idx1.reshape(-1),
        corr_img2=corr_img2.reshape(-1), corr_idx2=corr_idx2.reshape(-1),
        corr_conf=corr_conf.reshape(-1), corr_pair=corr_pair.reshape(-1),
        pair_img1=pair_img1, pair_img2=pair_img2,
        pair_matching_ok=pair_max_conf > matching_conf_thr,
        preds21_pts=preds_pts, preds21_conf=preds_conf,
        corr_pix1=(corr_pix1.reshape(-1, 2) if anchored else None),
        corr_pix2=(corr_pix2.reshape(-1, 2) if anchored else None),
        corr_doff1=(corr_doff1.reshape(-1) if anchored else None),
        corr_doff2=(corr_doff2.reshape(-1) if anchored else None),
    )
