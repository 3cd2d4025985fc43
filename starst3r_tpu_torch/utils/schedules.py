"""LR schedules and robust losses for global alignment (port of
`starst3r_tpu/utils/schedules.py`): the cosine LR schedule and the
alpha-annealed robust gamma loss (reference: starster/reconstruct.py:371-391).
``alpha`` may be a Python float or a tensor."""

from __future__ import annotations

import math

import torch

__all__ = ("cosine_schedule", "meta_gamma_loss")


def cosine_schedule(alpha, lr_base, lr_end=0.0):
    """alpha in [0, 1] (fraction of run completed) -> lr; half-cosine from
    lr_base at 0 to lr_end at 1."""
    cos = (torch.cos(math.pi * alpha) if isinstance(alpha, torch.Tensor)
           else math.cos(math.pi * alpha))
    return lr_end + (lr_base - lr_end) * (1.0 + cos) / 2.0


def meta_gamma_loss(dist, gamma: float, alpha, eps: float = 1e-3):
    """Annealed robust loss with exponent g = alpha * 1 + (1 - alpha) * gamma
    (alpha = 1 - step / niter: plain L1 at the start of a phase)."""
    g = alpha * 1.0 + (1.0 - alpha) * gamma
    return (dist + eps) ** g - eps ** g
