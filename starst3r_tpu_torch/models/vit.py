"""ViT encoder and cross-attention decoder blocks with 2D RoPE (port of
`starst3r_tpu/models/vit.py`).

Module and parameter names follow the public CroCo/DUSt3R/MASt3R checkpoint
layout (`enc_blocks.{i}.attn.qkv`, `dec_blocks.{i}.cross_attn.projq`, ...),
so the port's `state_dict` has the `.pth` key layout. Semantics as in the
JAX package: pre-LN blocks, LayerNorm eps 1e-5, exact (erf) GELU, the
decoder's cross-attention memory LayerNormed by `norm_y` (croco
norm_mem=True), RoPE on every self- and cross-attention q/k.

`Encoder` and `InterleavedDecoder` are the JAX package's two trunk modules
(their own parameter names: `patch_embed`, `blocks.{i}`, `norm`; `embed`,
`blocks.{i}`, `blocks2.{i}`, `norm`); `TwoViewNet` holds the same layers
under the checkpoint's names, and both run them through `encode_tokens`
and `decode_interleaved`. Parameters stay float32; for bfloat16 run the
forward under autocast, as `Mast3rModel` does.

Tensors are (B, T, C) token-major, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import rope_attention
from ..ops.rope import rope_2d_freqs

__all__ = ("PatchEmbed", "Mlp", "Attention", "CrossAttention",
           "EncoderBlock", "DecoderBlock", "Encoder", "InterleavedDecoder",
           "decode_interleaved", "encode_tokens", "patch_positions")

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
        return self.proj(rope_attention(q, k, v, rope, rope)
                         .reshape(b, t, -1))


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
        return self.proj(rope_attention(q, k, v, rope_q, rope_k)
                         .reshape(b, tq, -1))


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


def encode_tokens(patch_embed: PatchEmbed, blocks, norm: nn.LayerNorm,
                  img: torch.Tensor, rope: Rope) -> torch.Tensor:
    """The ViT encoder: img (B, H, W, 3) -> normalised tokens (B, T, C)."""
    x = patch_embed(img)
    for blk in blocks:
        x = blk(x, rope)
    return norm(x)


def decode_interleaved(embed: nn.Linear, blocks, blocks2, norm: nn.LayerNorm,
                       f1: torch.Tensor, f2: torch.Tensor, rope1: Rope,
                       rope2: Rope):
    """The CroCo interleaved two-stream decoder: both encoder streams
    through ONE ``embed``, then block i of each stack reads the previous
    pair (x1, x2), and one shared ``norm`` on both last states. Returns
    (states1, states2): the embedded tokens and every block's output,
    states{v}[i] being block i-1's."""
    x1, x2 = embed(f1), embed(f2)
    s1, s2 = [x1], [x2]
    for b1, b2 in zip(blocks, blocks2):
        x1, x2 = b1(x1, x2, rope1, rope2), b2(x2, x1, rope2, rope1)
        s1.append(x1)
        s2.append(x2)
    s1[-1] = norm(s1[-1])
    s2[-1] = norm(s2[-1])
    return s1, s2


class Encoder(nn.Module):
    """The JAX package's `Encoder`: patch embedding, ``depth`` pre-LN
    blocks with 2D RoPE, a final LayerNorm."""

    def __init__(self, depth: int, dim: int, heads: int,
                 patch_size: int = 16, mlp_ratio: float = 4.0,
                 rope_base: float = 100.0):
        super().__init__()
        self.head_dim, self.patch_size, self.rope_base = (
            dim // heads, patch_size, rope_base)
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.blocks = nn.ModuleList(
            [EncoderBlock(dim, heads, mlp_ratio) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img (B, H, W, 3) -> (B, T, dim)."""
        _, h, w, _ = img.shape
        pos = patch_positions(h // self.patch_size, w // self.patch_size,
                              img.device)[None]
        rope = rope_2d_freqs(pos, self.head_dim, self.rope_base)
        return encode_tokens(self.patch_embed, self.blocks, self.norm, img,
                             rope)


class InterleavedDecoder(nn.Module):
    """The JAX package's `InterleavedDecoder` (`decode_interleaved`):
    ``blocks.{i}`` is the checkpoint's ``dec_blocks.{i}``, ``blocks2.{i}``
    its ``dec_blocks2.{i}``."""

    def __init__(self, depth: int, dim: int, heads: int, enc_dim: int,
                 mlp_ratio: float = 4.0, rope_base: float = 100.0):
        super().__init__()
        self.head_dim, self.rope_base = dim // heads, rope_base
        self.embed = nn.Linear(enc_dim, dim)
        self.blocks = nn.ModuleList(
            [DecoderBlock(dim, heads, mlp_ratio) for _ in range(depth)])
        self.blocks2 = nn.ModuleList(
            [DecoderBlock(dim, heads, mlp_ratio) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, f1: torch.Tensor, f2: torch.Tensor, pos1: torch.Tensor,
                pos2: torch.Tensor):
        """f1, f2 (B, T, enc_dim) encoder outputs; pos1, pos2 (1, T, 2)
        patch coordinates. Returns (states1, states2)."""
        rope1 = rope_2d_freqs(pos1, self.head_dim, self.rope_base)
        rope2 = rope_2d_freqs(pos2, self.head_dim, self.rope_base)
        return decode_interleaved(self.embed, self.blocks, self.blocks2,
                                  self.norm, f1, f2, rope1, rope2)
