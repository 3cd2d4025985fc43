"""LR schedules and robust losses for global alignment (port of
`starst3r_tpu/utils/schedules.py`): the cosine and linear LR schedules,
the fixed robust gamma loss and its alpha-annealed form (reference:
starster/reconstruct.py:371-391). ``alpha`` may be a Python float or a
tensor."""

from __future__ import annotations

import math

import torch

__all__ = ("cosine_schedule", "linear_schedule", "gamma_loss",
           "meta_gamma_loss")


def cosine_schedule(alpha, lr_base, lr_end=0.0):
    """alpha in [0, 1] (fraction of run completed) -> lr; half-cosine from
    lr_base at 0 to lr_end at 1."""
    cos = (torch.cos(math.pi * alpha) if isinstance(alpha, torch.Tensor)
           else math.cos(math.pi * alpha))
    return lr_end + (lr_base - lr_end) * (1.0 + cos) / 2.0


def linear_schedule(alpha, lr_base, lr_end=0.0):
    return lr_base + (lr_end - lr_base) * alpha


def gamma_loss(dist, gamma: float, eps: float = 1e-3):
    """Robust |d|^gamma on nonnegative distances; eps keeps the gradient
    finite at 0."""
    return (dist + eps) ** gamma - eps ** gamma


def meta_gamma_loss(dist, gamma: float, alpha, eps: float = 1e-3):
    """Annealed robust loss with exponent g = alpha * 1 + (1 - alpha) * gamma
    (alpha = 1 - step / niter: plain L1 at the start of a phase)."""
    g = alpha * 1.0 + (1.0 - alpha) * gamma
    return (dist + eps) ** g - eps ** g
