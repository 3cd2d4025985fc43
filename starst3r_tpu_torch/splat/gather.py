"""The tile-entry gather as a standalone kernel: the hand-written CUDA
kernel (`csrc/gather_entries.cu`, the counterpart of the six Mosaic gather
probes in the JAX package's `tools/probe_mosaic_gather*.py`) and its plain
torch version.

    entries[c, t, k] = packed[gidx[c, t, k]] if ent_valid[c, t, k] else 0

packed (C*N, 9) float32 projected attributes, gidx (C, T, K) int32 rows of
packed (already offset by camera), ent_valid (C, T, K) bool. Returns
(C, T, K, 9) float32.

The rasterizer does not launch it: on its path the compositing kernels
stage each entry's row from ``packed`` themselves and their backward's
per-slot gradient is summed into ``packed``'s rows by the row-sum kernel
(`splat.composite.composite_packed`). `rasterize.tile_entries` still
gathers here, for `composite_tiles`' callers, the tests and chip_smoke.py,
which holds the kernel to its plain version.

  - `gather_entries_plain`: ``packed[gidx] * ent_valid[..., None]``; the CPU
    path (autograd differentiates it) and the kernel's yardstick.
  - `gather_entries_cuda`: launches the kernel on the current stream and
    counts the launch in `gather_entries_cuda.launches`.
  - `gather_entries`: CPU tensors take the plain version; CUDA tensors go
    through `GatherEntries`, a torch.autograd.Function whose forward is the
    kernel and whose backward sums each row's valid slots of the entries'
    gradient in a fixed order (`ops/row_sum.py`: the row-sum kernel
    through `masked_csr`, the JAX package's ``bw_idx`` backward of
    `_gather_packed`), with its non-finite elements counted on the device
    in ``GatherEntries.nonfinite``.
"""

from __future__ import annotations

import torch

from ..kernels import launch
from ..ops.row_sum import gather_rows_bwd_cuda, masked_csr

__all__ = ("GatherEntries", "gather_entries", "gather_entries_cuda",
           "gather_entries_plain")


def gather_entries_plain(packed: torch.Tensor, gidx: torch.Tensor,
                         ent_valid: torch.Tensor) -> torch.Tensor:
    return packed[gidx] * ent_valid[..., None]


def gather_entries_cuda(packed: torch.Tensor, gidx: torch.Tensor,
                        ent_valid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA gather. Checks device, types, shapes and layout."""
    if not packed.is_cuda:
        raise ValueError("gather_entries_cuda needs CUDA tensors")
    if packed.dtype != torch.float32 or packed.dim() != 2 \
            or packed.shape[1] != 9 or not packed.is_contiguous():
        raise ValueError("packed must be contiguous float32 (R, 9), got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if gidx.device != packed.device or gidx.dtype != torch.int32 \
            or not gidx.is_contiguous():
        raise ValueError("gidx must be contiguous int32 on packed's device, "
                         f"got {gidx.dtype} on {gidx.device}")
    if ent_valid.device != packed.device or ent_valid.dtype != torch.bool \
            or ent_valid.shape != gidx.shape or not ent_valid.is_contiguous():
        raise ValueError("ent_valid must be contiguous bool shaped as gidx "
                         "on packed's device")
    out = torch.empty(tuple(gidx.shape) + (9,), dtype=torch.float32,
                      device=packed.device)
    with torch.cuda.device(packed.device):
        launch("gather_entries", packed.data_ptr(), gidx.data_ptr(),
               ent_valid.data_ptr(), out.data_ptr(), gidx.numel(),
               torch.cuda.current_stream(packed.device).cuda_stream)
    gather_entries_cuda.launches += 1
    return out


gather_entries_cuda.launches = 0


class GatherEntries(torch.autograd.Function):
    """The CUDA gather with its gradient: the valid slots' gradients
    summed into the packed rows they came from, each row's in ascending
    slot position, by the row-sum kernel."""

    nonfinite = 0

    @staticmethod
    def forward(ctx, packed, gidx, ent_valid):
        ctx.save_for_backward(gidx, ent_valid)
        ctx.rows = packed.shape[0]
        return gather_entries_cuda(packed, gidx, ent_valid)

    @staticmethod
    def backward(ctx, grad):
        gidx, ent_valid = ctx.saved_tensors
        csr = masked_csr(gidx.reshape(-1), ent_valid.reshape(-1), ctx.rows)
        out = gather_rows_bwd_cuda(grad.reshape(-1, 9).contiguous(), *csr)
        # a 0-dim device tensor once added to: no wait for the card
        GatherEntries.nonfinite += (~torch.isfinite(out)).sum()
        return out, None, None


def gather_entries(packed: torch.Tensor, gidx: torch.Tensor,
                   ent_valid: torch.Tensor) -> torch.Tensor:
    """(C, T, K, 9) entries, differentiable in ``packed``: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if packed.is_cuda:
        return GatherEntries.apply(packed, gidx, ent_valid)
    if packed.device.type == "cpu":
        return gather_entries_plain(packed, gidx, ent_valid)
    raise ValueError(f"no entry gather for device {packed.device}")
