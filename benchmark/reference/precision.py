"""The precisions the references and their controls compute in: float32
with TF32 off (every reference), and the next precision below each one a
configuration states, for the controls: TF32 for float32 matmuls and
convolutions, float8 (e4m3, one scale per tensor) for the bfloat16
network, bfloat16 for float32 arithmetic that no TF32 flag reaches."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0     # the largest finite float8 e4m3 value


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in CUDA matmuls and convolutions on (the control) or off (the
    reference) inside the block; the previous flags after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to the format's largest value), returned in
    x's dtype: an operand of a float8 matmul."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    q = (x.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(x.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back: an operand computed in
    bfloat16."""
    return x.to(torch.bfloat16).to(x.dtype)
