"""Scaled-dot-product attention (port of `starst3r_tpu/ops/attention.py`),
by two routes:

  - `sdpa`: plain torch ops that build the whole (B, H, Tq, Tk) score
    matrix, softmax in float32. MASt3R's callers take it on every device:
    its largest attention is 768 tokens a view at 512 x 384, a 37.7 MB
    float32 score matrix a head-batch of one pair.
  - `fused_sdpa`: never materialises the scores. On a CUDA tensor it is
    PyTorch's flash-attention kernel (`F.scaled_dot_product_attention`
    under `sdpa_kernel(SDPBackend.FLASH_ATTENTION)`), in bfloat16, and
    raises where that kernel cannot take the inputs: there is no other
    route on the card. A CPU tensor takes `sdpa`'s einsum route. VGGT's
    blocks take it: a global block attends over all S x P tokens of a
    scene, 33,312 at 32 views of 518 x 392, whose float32 score matrix
    would be 71 GB a layer.
"""

from __future__ import annotations

import torch

__all__ = ("sdpa", "fused_sdpa")


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         impl: str = "xla") -> torch.Tensor:
    """q: (B, Tq, H, D), k/v: (B, Tk, H, D) -> (B, Tq, H, D). Softmax in
    float32 whatever the activation dtype.

    ``impl``: the JAX package's routes, "xla" (its fused attention) and
    "einsum"; both compute this function, and the port has one route for
    both. Any other value raises ValueError."""
    if impl not in ("xla", "einsum"):
        raise ValueError(f"sdpa impl must be 'xla' or 'einsum' (the port's "
                         f"one einsum route), not {impl!r}")
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def fused_sdpa(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
    """`sdpa`'s function without the score matrix: q (B, Tq, H, D), k/v
    (B, Tk, H, D) -> (B, Tq, H, D). On the card the flash kernel takes
    them as given (the caller casts to bfloat16), and a RuntimeError comes
    back where it cannot (float32 inputs, a head size it lacks). A CPU
    tensor takes `sdpa`. Every call counts in ``fused_sdpa.launches``, on
    the CPU too, so a CPU test sees which callers take the route."""
    if q.device.type != "cuda":
        out = sdpa(q, k, v)
    else:
        import torch.nn.functional as F
        from torch.nn.attention import SDPBackend, sdpa_kernel
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2),
                v.transpose(1, 2)).transpose(1, 2)
    fused_sdpa.launches += 1
    return out


fused_sdpa.launches = 0
