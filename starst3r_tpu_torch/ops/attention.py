"""Scaled-dot-product attention in plain torch ops (port of
`starst3r_tpu/ops/attention.py`). The token counts of this network are small
(196 per image at 224 px), so the score matrix is cheap to materialise."""

from __future__ import annotations

import torch

__all__ = ("sdpa",)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q: (B, Tq, H, D), k/v: (B, Tk, H, D) -> (B, Tq, H, D). Softmax in
    float32 whatever the activation dtype."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)
