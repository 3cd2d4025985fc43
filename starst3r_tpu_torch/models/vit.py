"""ViT encoder and cross-attention decoder blocks with 2D RoPE (port of
`starst3r_tpu/models/vit.py`).

Module and parameter names follow the public CroCo/DUSt3R/MASt3R checkpoint
layout (`enc_blocks.{i}.attn.qkv`, `dec_blocks.{i}.cross_attn.projq`, ...),
so the port's `state_dict` has the `.pth` key layout. Semantics as in the
JAX package: pre-LN blocks, LayerNorm eps 1e-5, exact (erf) GELU, the
decoder's cross-attention memory LayerNormed by `norm_y` (croco
norm_mem=True), RoPE on every self- and cross-attention q/k.

Tensors are (B, T, C) token-major, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import sdpa
from ..ops.rope import apply_rope_2d

__all__ = ("PatchEmbed", "Mlp", "Attention", "CrossAttention",
           "EncoderBlock", "DecoderBlock", "patch_positions")

Rope = Tuple[torch.Tensor, torch.Tensor]


def patch_positions(h_patches: int, w_patches: int,
                    device=None) -> torch.Tensor:
    """(T, 2) integer (y, x) patch-grid coordinates in raster order."""
    ys = torch.arange(h_patches, device=device).repeat_interleave(w_patches)
    xs = torch.arange(w_patches, device=device).repeat(h_patches)
    return torch.stack([ys, xs], dim=-1)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int = 16):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, patch_size)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) -> tokens (B, T, dim)."""
        x = self.proj(img.permute(0, 3, 1, 2))
        return x.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, out: Optional[int] = None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, out or dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, rope: Optional[Rope]):
        # self.heads is the heads this rank holds (all of them unless the
        # block is tensor-parallel, parallel/tp.py)
        b, t, _ = x.shape
        qkv = self.qkv(x).reshape(b, t, 3, self.heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        if rope is not None:
            q, k = apply_rope_2d(q, k, *rope)
        return self.proj(sdpa(q, k, v).reshape(b, t, -1))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, y, rope_q: Optional[Rope], rope_k: Optional[Rope]):
        """x: queries (B, Tq, C); y: keys/values source (B, Tk, C)."""
        b, tq, _ = x.shape
        hd = self.head_dim
        q = self.projq(x).reshape(b, tq, self.heads, hd)
        k = self.projk(y).reshape(b, -1, self.heads, hd)
        v = self.projv(y).reshape(b, -1, self.heads, hd)
        if rope_q is not None:
            q, _ = apply_rope_2d(q, q, *rope_q)
            k, _ = apply_rope_2d(k, k, *rope_k)
        return self.proj(sdpa(q, k, v).reshape(b, tq, -1))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, rope):
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """croco DecoderBlock: self-attention, cross-attention to the other
    stream's LayerNormed tokens, MLP; all pre-LN."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = Attention(dim, heads)
        self.cross_attn = CrossAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.norm_y = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, y, rope_x, rope_y):
        x = x + self.attn(self.norm1(x), rope_x)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), rope_x, rope_y)
        return x + self.mlp(self.norm3(x))
