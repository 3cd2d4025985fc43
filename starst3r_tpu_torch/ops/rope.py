"""2D rotary position embedding for ViT patch tokens (port of
`starst3r_tpu/ops/rope.py`, the croco RoPE2D convention):

  - the head dim D splits into halves: the first D/2 channels encode y, the
    last D/2 encode x;
  - within each half, rotate_half pairing: channel c pairs with c + D/4;
  - inv_freq[j] = base ** (-j / (D/4)), j in [0, D/4), base 100.
"""

from __future__ import annotations

import torch

__all__ = ("rope_2d_freqs", "apply_rope_2d")


def rope_2d_freqs(positions: torch.Tensor, head_dim: int,
                  base: float = 100.0):
    """positions (..., T, 2) integer (y, x) patch coordinates -> (cos, sin),
    each (..., T, head_dim), float32."""
    if head_dim % 4:
        raise ValueError(f"head_dim {head_dim} must be divisible by 4")
    quarter = head_dim // 4
    inv = 1.0 / (base ** (torch.arange(0, quarter, dtype=torch.float32,
                                       device=positions.device) / quarter))
    ay = positions[..., 0:1].to(torch.float32) * inv
    ax = positions[..., 1:2].to(torch.float32) * inv
    ang = torch.cat([ay, ay, ax, ax], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Quarters (a, b, c, d) -> (-b, a, -d, c)."""
    a, b, c, d = x.chunk(4, dim=-1)
    return torch.cat([-b, a, -d, c], dim=-1)


def apply_rope_2d(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor):
    """q, k: (..., T, H, D) with cos/sin (..., T, D) broadcast over heads."""
    cos_b = cos[..., :, None, :]
    sin_b = sin[..., :, None, :]
    q_out = q * cos_b + _rotate_half(q) * sin_b
    k_out = k * cos_b + _rotate_half(k) * sin_b
    return q_out.to(q.dtype), k_out.to(k.dtype)
