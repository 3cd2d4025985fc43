"""Scaled-dot-product attention (port of `starst3r_tpu/ops/attention.py`),
by three routes:

  - `sdpa`: plain torch ops that build the whole (B, H, Tq, Tk) score
    matrix, softmax in float32. VGGT's float32 camera trunk takes it, and
    `rope_attention`'s plain version.
  - `rope_attention`: MASt3R's attention with its 2D RoPE
    (`ops/rope.py::apply_rope_2d` on q and k, then `sdpa`). On a CUDA
    tensor it is one hand-written kernel (`csrc/rope_attention.cu`) that
    rotates q and k as they load and keeps the rotated q and k, the scores
    and the probabilities on the chip (the largest call, 768 tokens a view
    at 512 x 384, would write a 37.7 MB float32 score matrix a head-batch
    of one pair); it takes bfloat16 at head size 64 and float32 at 24, 32
    and 64, and raises on anything else. A CPU tensor takes the plain
    version.
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

import math
from typing import Optional, Tuple

import torch

from .rope import rope_rotate

__all__ = ("sdpa", "fused_sdpa", "rope_attention")

Rope = Tuple[torch.Tensor, torch.Tensor]


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


def _rope_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          rope_q: Optional[Rope], rope_k: Optional[Rope]
                          ) -> torch.Tensor:
    """`rope_attention`'s function as the port composed it before the
    kernel: `apply_rope_2d`'s rotation of q with ``rope_q`` and of k with
    ``rope_k``, then `sdpa`. Runs on any device (chip_smoke.py times it on
    the card)."""
    if rope_q is not None:
        q, k = rope_rotate(q, *rope_q), rope_rotate(k, *rope_k)
    return sdpa(q, k, v)


# (dtype, head size) the kernel has an instantiation of
_KERNEL_SHAPES = {(torch.bfloat16, 64): 0, (torch.float32, 24): 1,
                  (torch.float32, 32): 1, (torch.float32, 64): 1}


def _table(t: torch.Tensor, rows: int, d: int, dev: torch.device,
           name: str) -> torch.Tensor:
    """A rotary table as the kernel reads it: (rows, d) float32, contiguous
    and 16-byte aligned; leading dimensions of size 1 are dropped."""
    if t.dtype != torch.float32 or t.device != dev or t.shape[-2:] != (
            rows, d) or any(n != 1 for n in t.shape[:-2]):
        raise ValueError(f"{name} must be float32 (..., {rows}, {d}) on "
                         f"{dev} with leading dimensions of 1, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    t = t.reshape(rows, d).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rope_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         rope_q: Optional[Rope], rope_k: Optional[Rope]
                         ) -> torch.Tensor:
    from ..kernels import launch
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, T, H, D)")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    kind = _KERNEL_SHAPES.get((q.dtype, d))
    if kind is None:
        raise ValueError(f"the attention kernel takes bfloat16 at head size "
                         f"64 and float32 at 24, 32 and 64, not {q.dtype} "
                         f"at {d}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device or tuple(t.shape) != (
                b, tk, h, d):
            raise ValueError(f"{name} must be {q.dtype} ({b}, Tk, {h}, {d}) "
                             f"on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    # cp.async reads 16-byte chunks of bfloat16 rows
    align = 8 if kind == 0 else 1
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]) or (
                t.data_ptr() % (2 * align)):
            raise ValueError(f"{name}'s last stride must be 1 and the others "
                             f"multiples of {align} from an aligned start, "
                             f"got strides {t.stride()}")
    if tk == 0:
        raise ValueError("no keys to attend to")
    if b * h > 65535:
        raise ValueError(f"{b * h} batch-heads: the grid takes 65,535")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("the attention kernel has no backward")
    if rope_q is None:
        tables = [None] * 4
    else:
        tables = [_table(t, n, d, q.device, name) for t, n, name in (
            (rope_q[0], tq, "cos_q"), (rope_q[1], tq, "sin_q"),
            (rope_k[0], tk, "cos_k"), (rope_k[1], tk, "sin_k"))]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        launch("rope_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
               *(0 if t is None else t.data_ptr() for t in tables),
               out.data_ptr(), kind, b, h, tq, tk, d,
               *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               d ** -0.5 * math.log2(math.e),
               torch.cuda.current_stream(q.device).cuda_stream)
    return out


def rope_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   rope_q: Optional[Rope],
                   rope_k: Optional[Rope]) -> torch.Tensor:
    """MASt3R's attention: q (B, Tq, H, D) rotated by ``rope_q`` = (cos,
    sin), each (Tq, D) float32 (leading dimensions of 1 allowed), k and v
    (B, Tk, H, D) with k rotated by ``rope_k`` -> (B, Tq, H, D); no rotation
    where ``rope_q`` is None. q, k and v may be strided views (the last
    stride 1), as the `qkv` linear's unbind gives them.

    A CUDA tensor launches `csrc/rope_attention.cu` (bfloat16 at head size
    64, float32 at 24, 32 and 64; anything else raises ValueError, and
    there is no other route on the card); the output is contiguous. A CPU
    tensor takes the plain version, `apply_rope_2d` then `sdpa`. Every
    call counts in ``rope_attention.launches``, on the CPU too."""
    if q.device.type == "cuda":
        out = _rope_attention_cuda(q, k, v, rope_q, rope_k)
    elif q.device.type == "cpu":
        out = _rope_attention_plain(q, k, v, rope_q, rope_k)
    else:
        raise ValueError(f"rope_attention runs on cuda or cpu, not "
                         f"{q.device}")
    rope_attention.launches += 1
    return out


rope_attention.launches = 0
