"""MASt3R's attention calls as the blocks make them, and float64 attention
on them, without JAX, so the GPU tests (tests/test_torch_cuda.py), the CPU
tests (tests/test_torch_model.py) and chip_smoke.py share them."""

import torch

from starst3r_tpu_torch.models.vit import patch_positions
from starst3r_tpu_torch.ops.rope import apply_rope_2d, rope_2d_freqs


def attention_inputs(dev, b, grid, heads, d, kind, dtype, seed,
                     grid_k=None):
    """(q, k, v, rope_q, rope_k) of one call over a ``grid`` of patches:
    "self" unbinds a (B, T, 3, H, D) `qkv` as `Attention` does (strided
    views, one table); "cross" takes three projections, q (B, Tq, H, D)
    and k, v over ``grid_k`` (``grid`` by default), the key side's table
    from that grid moved by (3, 5) patches; "none" has no tables."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    t = grid[0] * grid[1]
    rope_q = rope_2d_freqs(patch_positions(*grid, dev)[None], d)
    if kind == "self":
        q, k, v = randn(b, t, 3, heads, d).unbind(2)
        return q, k, v, rope_q, rope_q
    grid_k = grid_k or grid
    tk = grid_k[0] * grid_k[1]
    q, k, v = (randn(b, n, heads, d) for n in (t, tk, tk))
    if kind == "none":
        return q, k, v, None, None
    pos_k = patch_positions(*grid_k, dev)[None] + torch.tensor([3, 5],
                                                               device=dev)
    return q, k, v, rope_q, rope_2d_freqs(pos_k, d)


def attention_f64(q, k, v, rope_q, rope_k):
    """float64 attention on q and k rotated by `apply_rope_2d` in their own
    dtype (as the kernel rotates them) and v."""
    if rope_q is not None:
        q, _ = apply_rope_2d(q, q, *rope_q)
        k, _ = apply_rope_2d(k, k, *rope_k)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double())
    p = torch.softmax(s * q.shape[-1] ** -0.5, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.double())
