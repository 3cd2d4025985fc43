"""Reciprocal nearest-neighbour descriptor matching on a subsampled grid
(port of `starst3r_tpu/ops/matching.py`; reference subsample:
starster/reconstruct.py:80 `subsample=8`).

Descriptors are sampled every ``subsample`` pixels (grid anchored at
``subsample // 2``). The similarity between the two grids is one matmul,
then row/column argmax and a mutual check. Outputs have a fixed length n1
with a validity mask. The correspondence confidence is
sqrt(conf1[p1] * conf2[p2]) of the pointmap confidences.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

__all__ = ("PairMatches", "subsample_grid_indices", "reciprocal_nn",
           "match_pair", "refine_matches")


class PairMatches(NamedTuple):
    """Fixed-size match set for one ordered pair (i -> j), length n1."""

    idx1: torch.Tensor   # (n1,) int64 grid index in image i (= arange)
    idx2: torch.Tensor   # (n1,) int64 matched grid index in image j
    conf: torch.Tensor   # (n1,) float32, 0 where invalid
    mask: torch.Tensor   # (n1,) bool
    sim: torch.Tensor    # (n1,) float32 descriptor similarity, -inf if invalid


def subsample_grid_indices(h: int, w: int, subsample: int, device=None
                           ) -> Tuple[torch.Tensor, int, int]:
    """Flat pixel indices of the anchor grid (pixels subsample//2 + k*s).
    Returns (flat_idx (hs*ws,) int64, hs, ws)."""
    off = subsample // 2
    ys = torch.arange(off, h, subsample, device=device)
    xs = torch.arange(off, w, subsample, device=device)
    flat = (ys[:, None] * w + xs[None, :]).reshape(-1)
    return flat, ys.shape[0], xs.shape[0]


def match_pair(desc1: torch.Tensor, desc2: torch.Tensor,
               conf1: torch.Tensor, conf2: torch.Tensor,
               subsample: int = 8) -> PairMatches:
    """desc1/desc2 (H, W, D) unit-norm descriptors; conf1/conf2 (H, W)."""
    h, w, d = desc1.shape
    grid, _, _ = subsample_grid_indices(h, w, subsample, desc1.device)
    d1 = desc1.reshape(h * w, d)[grid]
    d2 = desc2.reshape(h * w, d)[grid]
    c1 = conf1.reshape(h * w)[grid]
    c2 = conf2.reshape(h * w)[grid]
    return reciprocal_nn(d1, d2, c1, c2)


def reciprocal_nn(d1: torch.Tensor, d2: torch.Tensor,
                  c1: torch.Tensor, c2: torch.Tensor) -> PairMatches:
    """Mutual nearest neighbours between d1 (n1, D) and d2 (n2, D) by dot
    product. argmax returns the first maximum, as in JAX."""
    n1 = d1.shape[0]
    sim = d1.float() @ d2.float().T                   # (n1, n2)
    nn12 = torch.argmax(sim, dim=1)
    nn21 = torch.argmax(sim, dim=0)
    best_sim = torch.amax(sim, dim=1)
    ar = torch.arange(n1, device=d1.device)
    mutual = nn21[nn12] == ar
    conf = torch.sqrt(torch.clamp(c1 * c2[nn12], min=0.0))
    conf = torch.where(mutual, conf, torch.zeros_like(conf))
    return PairMatches(
        idx1=ar, idx2=nn12, conf=conf.float(), mask=mutual,
        sim=torch.where(mutual, best_sim,
                        torch.full_like(best_sim, -float("inf"))))


def refine_matches(desc1: torch.Tensor, desc2: torch.Tensor,
                   m: PairMatches, subsample: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-accurate refinement of grid matches: for each match, pix2 is
    the best response in the (subsample+1)^2 window around idx2's grid pixel
    to desc1 at idx1's grid pixel; pix1 is then the best response around
    idx1's grid pixel to desc2 at pix2 (chained, so the two ends form one
    correspondence). Returns (pix1 (n, 2), pix2 (n, 2)) float32 (x, y)."""
    h, w, d = desc1.shape
    dev = desc1.device
    grid, _, _ = subsample_grid_indices(h, w, subsample, dev)
    r = subsample // 2
    dy, dx = torch.meshgrid(torch.arange(-r, r + 1, device=dev),
                            torch.arange(-r, r + 1, device=dev),
                            indexing="ij")
    offs_y = dy.reshape(-1)
    offs_x = dx.reshape(-1)
    gx = grid % w
    gy = grid // w

    def one_side(q, ctr_y, ctr_x, tgt_flat):
        cy = torch.clamp(ctr_y[:, None] + offs_y[None, :], 0, h - 1)
        cx = torch.clamp(ctr_x[:, None] + offs_x[None, :], 0, w - 1)
        cand = tgt_flat[(cy * w + cx).reshape(-1)].reshape(q.shape[0], -1, d)
        sim = torch.einsum("nd,nwd->nw", q, cand)
        best = torch.argmax(sim, dim=1, keepdim=True)
        return (torch.gather(cy, 1, best)[:, 0],
                torch.gather(cx, 1, best)[:, 0])

    d1f = desc1.reshape(h * w, d).float()
    d2f = desc2.reshape(h * w, d).float()
    q1 = d1f[grid[m.idx1]]
    p2y, p2x = one_side(q1, gy[m.idx2], gx[m.idx2], d2f)
    q2 = d2f[p2y * w + p2x]
    p1y, p1x = one_side(q2, gy[m.idx1], gx[m.idx1], d1f)
    pix1 = torch.stack([p1x, p1y], -1).float()
    pix2 = torch.stack([p2x, p2y], -1).float()
    return pix1, pix2
