"""Fixed-order row sums: d[r] = the sum of the cotangent rows whose index
is r, the backward of a row gather. On the card a kernel written for it
(`csrc/gather_rows_bwd.cu`: each row's entries read through a CSR, a long
row split over a thread-block cluster, no atomics), so a call gives the
same bits every time; on the CPU ``index_add_``, the plain version.

Its users: the rasterizer's packed backward, which sums each Gaussian's
slots of K2's per-slot gradient (`splat/composite.py::CompositePacked`, the
JAX package's ``bw_idx`` backward of `_gather_packed`), the standalone
entry gather's backward (`splat/gather.py`), and the polish's normal
equations (`alignment/lm.py`, `alignment/schur.py`, through
`index_add_rows`). The GA's fused loss (`alignment/ga_loss.py::
make_loss_data`) reads its correspondences and pairs in `_gather_csr`'s
row order.

  - `_gather_csr(idx, R)` / `masked_csr(idx, valid, R)`: the rows' entries
    as the kernel reads them, (order, offsets); the masked form leaves the
    invalid entries in a tail of ``order`` past offsets[R] that no row
    reads;
  - `_gather_plan`: the kernel's launch shape, from (M, R, D) alone;
  - `gather_rows_bwd_cuda`: the launch, counted in ``.launches``;
  - `_gather_rows_bwd_plain`: the kernel's function by ``index_add_``, the
    plain version the tests hold it to;
  - `_gather_rows_bwd_in_order`: the kernel's exact summation order in
    plain PyTorch (the bits the card's tests hold the kernel to);
  - `index_add_rows`: ``out.index_add_(0, idx, values)`` for several
    (idx, values) pairs, through the kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..kernels import launch

__all__ = ("gather_rows_bwd_cuda", "index_add_rows", "masked_csr")

# the row-gather backward kernel's launch limits (csrc/gather_rows_bwd.cu):
# threads a block, columns a tile, blocks a cluster (the portable size); a
# block of fewer than _MIN_THREADS threads takes several short rows. The
# plan gives each row about mean / _ENTRIES_PER_THREAD threads (the
# kernel's batch of loads in flight), spread over a cluster only once a
# row needs more than _CLUSTER_FROM of them (the cluster's syncs cost more
# than they save on shorter rows)
_MAX_THREADS, _MIN_THREADS, _MAX_TILE, _MAX_CLUSTER = 1024, 256, 32, 8
_ENTRIES_PER_THREAD, _CLUSTER_FROM = 8, 64


class _RowsPlan(NamedTuple):
    """The row-gather backward kernel's launch shape: ``vec`` floats a
    thread loads at once (4 where D is a multiple of 4), ``tile_w``
    threads across a tile of tile_w * vec columns, ``groups`` threads
    splitting each row's share of entries (a power of two, combined by a
    tree), ``rows_per_block`` rows a block and ``cluster`` blocks (a
    thread-block cluster) splitting each row's entries into consecutive
    shares."""

    vec: int
    tile_w: int
    groups: int
    rows_per_block: int
    cluster: int

    @property
    def threads(self) -> int:
        return self.tile_w * self.groups * self.rows_per_block

    def grid(self, rows: int, width: int) -> Tuple[int, int]:
        """(blocks along x: row blocks times the cluster, column tiles)."""
        cols = width // self.vec
        return (-(-rows // self.rows_per_block) * self.cluster,
                -(-cols // self.tile_w))


def _next_pow2(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def _gather_plan(entries: int, rows: int, width: int) -> _RowsPlan:
    """The kernel's launch shape for ``entries`` cotangent rows of
    ``width`` floats summed into ``rows`` rows, from the shapes alone (so
    the summation order, and the bits, depend on nothing else)."""
    vec = 4 if width % 4 == 0 else 1
    tile_w = max(min(width // vec, _MAX_TILE), 1)
    mean = max(-(-entries // max(rows, 1)), 1)
    per_row = _next_pow2(-(-mean // _ENTRIES_PER_THREAD))
    cluster = min(max(per_row // _CLUSTER_FROM, 1), _MAX_CLUSTER)
    most = 1 << ((_MAX_THREADS // tile_w).bit_length() - 1)
    groups = min(per_row // cluster, most)
    rows_per_block = max(min(_MIN_THREADS // (tile_w * groups), rows), 1)
    return _RowsPlan(vec, tile_w, groups, rows_per_block, cluster)


def _gather_rows_bwd_plain(idx: torch.Tensor, ct: torch.Tensor,
                           nrows: int) -> torch.Tensor:
    """The kernel's plain version: d[r] = sum of ct[m] over the m with
    idx[m] == r, (nrows, D), by ``index_add_``."""
    return ct.new_zeros((nrows,) + tuple(ct.shape[1:])).index_add_(0, idx, ct)


def _gather_rows_bwd_in_order(ct: torch.Tensor, order: torch.Tensor,
                              offsets: torch.Tensor) -> torch.Tensor:
    """The kernel's function with its exact summation order, in plain
    PyTorch (float32 adds in the same order give the same bits): each
    row's entries cut into the plan's ``cluster`` consecutive shares, each
    share's entries g, g + groups, ... summed in turn, a tree over the
    groups, then the shares in rank order. The plan comes from ct's shape,
    as the kernel's does; ``order`` may run past offsets[R] (entries in no
    row, never read). The card's tests hold the kernel to it bit for
    bit."""
    m, width = ct.shape
    rows = offsets.numel() - 1
    plan = _gather_plan(m, rows, width)
    n_rank, groups = plan.cluster, plan.groups
    dev = ct.device
    off = offsets.long()
    counts = off[1:] - off[:-1]
    share = ((counts + n_rank - 1) // n_rank)[:, None, None]  # (R, 1, 1)
    depth = (int(share.max()) + groups - 1) // groups if rows else 0
    rank = torch.arange(n_rank, device=dev)[:, None]            # (n, 1)
    group = torch.arange(groups, device=dev)                    # (g,)
    first = off[:-1, None, None] + rank * share                 # (R, n, 1)
    rest = counts[:, None, None] - rank * share
    order = order.long()
    last = max(order.numel() - 1, 0)
    padded = torch.cat([ct, ct.new_zeros((1, width))])
    acc = ct.new_zeros((rows, n_rank, groups, width))
    # step i: group g of rank q adds the share's entry i * groups + g, or
    # +0 (the padding row) past the share or the row; a sum that starts
    # at +0 is never -0, so the +0s leave the bits as the kernel's
    for i in range(depth):
        within = i * groups + group                              # (g,)
        live = (within < share) & (within < rest)                # (R, n, g)
        k = torch.clamp(first + within, max=last)
        src = torch.where(live, order[k], torch.full_like(k, m))
        acc = acc + padded[src]
    s = groups // 2
    while s:
        acc[:, :, :s] = acc[:, :, :s] + acc[:, :, s:2 * s]
        s //= 2
    out = acc[:, 0, 0]
    for q in range(1, n_rank):
        out = out + acc[:, q, 0]
    return out


def gather_rows_bwd_cuda(ct: torch.Tensor, order: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA row-sum kernel: d[r] = sum of ct[order[k]] for k in
    [offsets[r], offsets[r+1]), (R, D) float32, every row written (an
    empty row is 0), with `_gather_plan`'s launch shape, taken from
    (M, R, D). ``order`` has M entries; those past offsets[R] are in no
    row and never read. Checks device, types, shapes and layout."""
    if not ct.is_cuda:
        raise ValueError("gather_rows_bwd_cuda needs CUDA tensors")
    if ct.dtype != torch.float32 or ct.dim() != 2 or not ct.is_contiguous():
        raise ValueError("ct must be contiguous float32 (M, D), got "
                         f"{ct.dtype} {tuple(ct.shape)}")
    m, width = ct.shape
    for name, t, n in (("order", order, m), ("offsets", offsets, None)):
        if t.device != ct.device or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous() or (n is not None and t.numel() != n):
            raise ValueError(f"{name} must be contiguous int32 (1-D) on ct's "
                             f"device, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    rows = offsets.numel() - 1
    plan = _gather_plan(m, max(rows, 0), width)
    if rows < 0 or plan.grid(rows, width)[1] > 65535:
        raise ValueError(f"{rows} rows of width {width}: offsets needs R + 1 "
                         "entries and the kernel's grid at most 65,535 "
                         "column tiles")
    if plan.vec == 4 and ct.data_ptr() % 16:
        ct = ct.clone()          # the kernel reads float4s: 16-byte aligned
    d = torch.empty((rows, width), dtype=torch.float32, device=ct.device)
    with torch.cuda.device(ct.device):
        launch("gather_rows_bwd_split", ct.data_ptr(), order.data_ptr(),
               offsets.data_ptr(), d.data_ptr(), rows, width, *plan,
               torch.cuda.current_stream(ct.device).cuda_stream)
    gather_rows_bwd_cuda.launches += 1
    return d


# under a CUDA graph this counts the launches Python sees: the warm-up steps
# and the capture, not the replays
gather_rows_bwd_cuda.launches = 0


def _gather_csr(idx: torch.Tensor, nrows: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of ``idx`` over a table of ``nrows`` rows, as the kernel
    reads them: (order, offsets), ``order`` (M,) int32 a stable argsort of
    idx (each row's entries keep their order) and ``offsets`` (nrows + 1,)
    int32 the cumulative counts, so row r's entries are
    order[offsets[r]:offsets[r + 1]]."""
    if idx.numel() >= 2 ** 31:
        raise ValueError(f"{idx.numel()} entries: the kernel indexes int32")
    counts = torch.bincount(idx, minlength=nrows)
    if counts.numel() != nrows:
        raise ValueError(f"an index reaches past the table's {nrows} rows")
    offsets = torch.zeros(nrows + 1, dtype=torch.int32, device=idx.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return torch.argsort(idx, stable=True).to(torch.int32), offsets


def masked_csr(idx: torch.Tensor, valid: torch.Tensor, nrows: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_gather_csr` of the entries of ``idx`` (M,) where ``valid`` (M,)
    holds: (order (M,) int32, offsets (nrows + 1,) int32), each row's
    entries in ascending position, and the invalid entries (whatever their
    index) after offsets[nrows], in no row. A stable sort of the index
    with the invalid entries keyed past the last row, and each row's start
    by a binary search of the sorted keys: integers only, no read back to
    the host, the same result on every device."""
    if idx.numel() >= 2 ** 31 or nrows >= 2 ** 31 - 1:
        raise ValueError(f"{idx.numel()} entries over {nrows} rows: the "
                         "kernel indexes int32")
    idx = idx.to(torch.int32)
    key, order = torch.sort(
        torch.where(valid, idx, torch.full_like(idx, nrows)), stable=True)
    offsets = torch.searchsorted(
        key, torch.arange(nrows + 1, dtype=torch.int32, device=idx.device),
        out_int32=True)
    return order.to(torch.int32), offsets


def index_add_rows(out: torch.Tensor, *pairs) -> torch.Tensor:
    """``out.index_add_(0, idx, values)`` for each (idx, values) pair in
    turn, in place, and returns ``out``. On the CPU that is what it does
    (the plain version); on the card the pairs' values go through one
    `gather_rows_bwd_cuda` in a fixed order (float32 only) and the sum is
    added to ``out``, so a call gives the same bits every time, where
    ``index_add_``'s adds on the card come in no fixed order."""
    if not out.is_cuda:
        for idx, values in pairs:
            out.index_add_(0, idx, values)
        return out
    idx = torch.cat([i.reshape(-1) for i, _ in pairs])
    values = torch.cat([v.reshape(v.shape[0], -1) for _, v in pairs])
    rows = gather_rows_bwd_cuda(values.contiguous(),
                                *_gather_csr(idx, out.shape[0]))
    return out.add_(rows.reshape(out.shape))
