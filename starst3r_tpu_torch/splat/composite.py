"""Per-tile front-to-back alpha compositing and its gradient: the
hand-written CUDA kernels (`csrc/composite_fwd.cu`, replacing the JAX
package's Pallas `_fwd_kernel`, and `csrc/composite_bwd.cu`, replacing
`_bwd_kernel`) and their plain torch versions.

  - `composite_tiles_plain`: the port of `rasterize._composite_tiles` (the
    JAX package's reference path), batched over cameras, with torch.cumprod
    inside fixed-length chunks and no early exit. The CPU path (autograd
    differentiates it), and the yardstick the forward kernel is held to on
    the card.
  - `composite_tiles_bwd_plain`: the gradient of the plain version with
    respect to the entries (torch.autograd.grad), with the slots past the
    batches the forward kernel processed set to zero. The yardstick the
    backward kernel is held to; the tests and chip_smoke.py use it.
  - `done_plain`: the batches the forward kernel's early exit processes
    (its ``done``), by the plain version's transmittance; the tests and
    chip_smoke.py hold the kernel's to it.
  - `cull_boxes_plain`: each entry's cull box, the pixel rectangle of its
    tile outside of which the culls cannot pass, as both kernels compute it
    to skip the (warp, entry) pairs that would be culled. Not on the main
    path: the tests and chip_smoke.py's work counts use it.
  - `composite_tiles_cuda` / `composite_tiles_bwd_cuda`: launch the forward
    and the backward kernel on the current stream (built on first use by
    `starst3r_tpu_torch.kernels`) and count their launches in ``.launches``.
  - `composite_tiles`: compositing of gathered entries. CPU tensors take
    the plain version; CUDA tensors go through `CompositeTiles`, a
    torch.autograd.Function whose forward is the forward kernel and whose
    backward is the backward kernel (the non-finite elements of the
    gradients it hands back are counted, on the device, in
    ``CompositeTiles.nonfinite``), or raise. `tile_entries`' callers, the
    tests and chip_smoke.py use it; the rasterizer does not.
  - the packed routes, the rasterizer's: the same kernels with the entry
    gather as their staging (`csrc/composite_common.cuh::PackedRows`), so
    no (C, T, K, 9) entries are materialised. `composite_packed_cuda` /
    `composite_packed_slots_cuda` launch them and count their launches in
    ``.launches``. The backward kernel stores each slot's gradient into a
    (C*T*K, 9) buffer, zero-filled here, and `composite_packed_bwd_cuda`
    sums each table row's slots in a fixed order with the row-sum kernel
    (`ops/row_sum.py::gather_rows_bwd_cuda`) through `packed_csr`, the
    port's form of the JAX package's ``Bins.bw_idx``: no atomics, so a
    training step gives the same bits every time. `composite_packed_bwd_plain`
    is the backward's yardstick (an ``index_add_`` of
    `composite_tiles_bwd_plain` into the table); `composite_packed`, the
    rasterizer's entry, takes the plain chain
    ``composite_tiles_plain(gather_entries_plain(...))`` for CPU tensors
    (autograd differentiates it) and `CompositePacked` for CUDA tensors
    (non-finite gradient elements counted in
    ``CompositePacked.nonfinite``), or raises.

Inputs: entries (C, T, K, 9) float32 [mx, my, conic a, b, c, r, g, b, op],
depth-ordered per tile, zero past each tile's count; counts (C, T) int32.
The packed routes take packed (C*N, 9) float32 rows of those attributes and
gidx (C, T, K) int32 rows of packed (the binning's, offset by camera)
instead of entries: slot k of tile t is row gidx[c, t, k] for
k < counts[c, t], which is exactly the binning's ent_valid.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .gather import gather_entries_plain
from ..kernels import launch
from ..ops.row_sum import gather_rows_bwd_cuda, masked_csr

__all__ = ("CompositePacked", "CompositeTiles", "composite_packed",
           "composite_packed_bwd_cuda", "composite_packed_bwd_plain",
           "composite_packed_cuda", "composite_packed_slots_cuda",
           "composite_tiles", "composite_tiles_bwd_cuda",
           "composite_tiles_bwd_plain", "composite_tiles_cuda",
           "composite_tiles_plain",
           "cull_boxes_plain", "done_plain", "packed_csr", "slot_valid")

BATCH = 128     # the kernels' batch of entries (the TPU kernels' chunk)


def _tile_pix(tw: int, th: int, tile: int, device):
    """Pixel-centre coordinates per tile: (T, P) each for x and y."""
    p = torch.arange(tile * tile, device=device)
    t = torch.arange(tw * th, device=device)
    x = (t % tw)[:, None] * tile + (p % tile)[None] + 0.5
    y = (t // tw)[:, None] * tile + (p // tile)[None] + 0.5
    return x.float(), y.float()


def _tiles_to_image(vals: torch.Tensor, c: int, h: int, w: int, tile: int,
                    tw: int, th: int) -> torch.Tensor:
    """(C*T, P, ...) per-tile pixel values -> (C, H, W, ...)."""
    rest = vals.shape[2:]
    v = vals.reshape((c, th, tw, tile, tile) + rest)
    v = v.permute((0, 1, 3, 2, 4) + tuple(range(5, 5 + len(rest))))
    return v.reshape((c, th * tile, tw * tile) + rest)[:, :h, :w]


def composite_tiles_plain(entries: torch.Tensor, counts: torch.Tensor,
                          h: int, w: int, tile: int, tw: int, th: int,
                          chunk: int = 128
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch compositing, no early exit. Chunks of ``chunk`` slots
    that lie wholly past a tile's count are skipped: their entries have
    opacity 0 and change nothing. Computes in float32, or in float64 when
    the entries are float64 (a reference for the float32 versions).
    Returns rgb (C, H, W, 3), alpha (C, H, W)."""
    c, t_total, k, _ = entries.shape
    dt = torch.float64 if entries.dtype == torch.float64 else torch.float32
    e = entries.reshape(c * t_total, k, 9).to(dt)
    cnt = counts.reshape(-1).to(e.device)
    pix_x, pix_y = (p.to(dt) for p in _tile_pix(tw, th, tile, e.device))
    pix_x = pix_x.repeat(c, 1)[:, None, :]                    # (CT, 1, P)
    pix_y = pix_y.repeat(c, 1)[:, None, :]
    acc_rgb = torch.zeros((c * t_total, tile * tile, 3), dtype=dt,
                          device=e.device)
    acc_t = torch.ones((c * t_total, tile * tile), dtype=dt, device=e.device)
    n_slots = min(k, int(cnt.max())) if cnt.numel() else 0
    for s in range(0, n_slots, chunk):
        act = torch.nonzero(cnt > s).squeeze(1)               # tiles reached
        ch = e[act, s:s + chunk]                              # (A, c, 9)
        dx = pix_x[act] - ch[:, :, 0:1]                       # (A, c, P)
        dy = pix_y[act] - ch[:, :, 1:2]
        sigma = (0.5 * (ch[:, :, 2:3] * dx * dx + ch[:, :, 4:5] * dy * dy)
                 + ch[:, :, 3:4] * dx * dy)
        # clip before the exp, as the JAX reference does
        alpha = ch[:, :, 8:9] * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
        alpha = torch.where((sigma >= 0.0) & (alpha > 1.0 / 255.0),
                            torch.clamp(alpha, max=0.999),
                            torch.zeros_like(alpha))
        cum = torch.cumprod(1.0 - alpha, dim=1)
        cum_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], 1)
        wgt = alpha * cum_excl * acc_t[act][:, None, :]
        acc_rgb = acc_rgb.index_add(
            0, act, torch.einsum("tcp,tcd->tpd", wgt, ch[:, :, 5:8]))
        acc_t = acc_t * torch.ones_like(acc_t).index_copy(0, act, cum[:, -1])
    rgb = _tiles_to_image(acc_rgb, c, h, w, tile, tw, th)
    alpha = 1.0 - _tiles_to_image(acc_t, c, h, w, tile, tw, th)
    return rgb, alpha


def done_plain(entries: torch.Tensor, counts: torch.Tensor, tile: int,
               tw: int, th: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's ``done`` by the plain version's arithmetic:
    batch 0 of every tile with entries, then batch b while some pixel of
    the tile has T > 1e-6 after batch b - 1 (T from chunked cumulative
    products, as `composite_tiles_plain`). Returns (done (C*T,) int64,
    near (C*T,) bool): ``near`` marks the tiles where the largest T at a
    batch boundary lies within 0.1% of 1e-6, where the kernel's sequential
    product may round to the other side."""
    c, t_total, k, _ = entries.shape
    e = entries.reshape(c * t_total, k, 9).float()
    cnt = torch.clamp(counts.reshape(-1).long().to(e.device), 0, k)
    pix_x, pix_y = _tile_pix(tw, th, tile, e.device)
    pix_x = pix_x.repeat(c, 1)[:, None, :]
    pix_y = pix_y.repeat(c, 1)[:, None, :]
    acc_t = torch.ones((c * t_total, tile * tile), device=e.device)
    done = torch.zeros(c * t_total, dtype=torch.long, device=e.device)
    near = torch.zeros(c * t_total, dtype=torch.bool, device=e.device)
    for s in range(0, int(cnt.max()) if cnt.numel() else 0, BATCH):
        started = (cnt > s) & ((s == 0) | (acc_t.amax(1) > 1e-6))
        act = torch.nonzero(started).squeeze(1)
        if act.numel() == 0:
            break
        done[act] += 1
        ch = e[act, s:s + BATCH]
        slot = torch.arange(s, s + ch.shape[1], device=e.device)
        live = (slot[None] < cnt[act][:, None])[..., None]
        dx = pix_x[act] - ch[:, :, 0:1]
        dy = pix_y[act] - ch[:, :, 1:2]
        sigma = (0.5 * (ch[:, :, 2:3] * dx * dx + ch[:, :, 4:5] * dy * dy)
                 + ch[:, :, 3:4] * dx * dy)
        alpha = ch[:, :, 8:9] * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
        alpha = torch.where(live & (sigma >= 0.0) & (alpha > 1.0 / 255.0),
                            torch.clamp(alpha, max=0.999),
                            torch.zeros_like(alpha))
        acc_t[act] = acc_t[act] * torch.cumprod(1.0 - alpha, dim=1)[:, -1]
        near[act] |= (acc_t[act].amax(1) - 1e-6).abs() <= 1e-9
    return done, near


def cull_boxes_plain(entries: torch.Tensor, tile: int, tw: int, th: int
                     ) -> torch.Tensor:
    """Each entry's cull box, as the kernels compute it
    (`csrc/composite_common.cuh::cull_box`, operation for operation in
    float32): the tile-local pixel rectangle outside of which the culls
    (sigma >= 0 and op * exp(-sigma) > 1/255) cannot pass, conservative
    against the rounding of the falloff. entries (C, T, K, 9) with
    T == tw * th. Returns (C, T, K, 4) int32 inclusive bounds
    (x0, x1, y0, y1); an empty box is (0, -1, 0, -1), a box that cannot be
    bounded (non-finite attributes, a conic that is not positive definite
    or is near-degenerate) the whole tile. The tests and chip_smoke.py's
    work counts use it; the kernels compute their own."""
    e = entries.float()
    t_total = e.shape[1]
    if t_total != tw * th:
        raise ValueError(f"{t_total} tiles, not {tw}x{th}")
    t = torch.arange(t_total, device=e.device)
    ox = ((t % tw) * tile).float()[None, :, None]
    oy = ((t // tw) * tile).float()[None, :, None]
    mx, my, ca, cb, cc, op = (e[..., i] for i in (0, 1, 2, 3, 4, 8))
    visible = op > 1.0 / 255.0
    finite = torch.isfinite(e[..., [0, 1, 2, 3, 4, 8]]).all(-1)
    ac = ca * cc
    det = ac - cb * cb
    s = (torch.log(255.0 * op) + 1e-5) * 1.01
    ellipse = (finite & (ca > 0) & (cc > 0) & (det > 1e-3 * ac)
               & (s < 49.0))
    two_s = 2.0 * s
    bounds = []
    for centre, origin, num in ((mx, ox, cc), (my, oy, ca)):
        ext = torch.sqrt(two_s * num / det) * 1.001
        c = (centre - origin) - 0.5
        r = (ext + 1.0) + 1e-5 * c.abs()
        lo = torch.ceil(torch.clamp(torch.clamp(c - r, min=-1.0),
                                    max=float(tile)))
        hi = torch.floor(torch.clamp(torch.clamp(c + r, max=float(tile)),
                                     min=-1.0))
        # NaN where the box is not an ellipse's; replaced below
        lo = torch.where(ellipse, lo, torch.zeros_like(lo))
        hi = torch.where(ellipse, hi, torch.zeros_like(hi))
        bounds += [torch.clamp(lo.int(), min=0),
                   torch.clamp(hi.int(), max=tile - 1)]
    box = torch.stack(bounds, -1)
    whole = torch.tensor([0, tile - 1, 0, tile - 1], dtype=torch.int32,
                         device=e.device)
    empty = torch.tensor([0, -1, 0, -1], dtype=torch.int32, device=e.device)
    box = torch.where(ellipse[..., None], box, whole)
    none = ~visible | (box[..., 0] > box[..., 1]) | (box[..., 2] > box[..., 3])
    return torch.where(none[..., None], empty, box)


def _check_tiles(c: int, t_total: int, counts: torch.Tensor, device,
                 h: int, w: int, tile: int, tw: int, th: int) -> None:
    """The tile grid and counts every kernel route takes."""
    if t_total != tw * th or h > th * tile or w > tw * tile:
        raise ValueError(f"{t_total} tiles do not cover {h}x{w} at "
                         f"{tw}x{th} tiles of {tile}")
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile {tile}: one thread per pixel needs "
                         "tile*tile <= 1024")
    if counts.device != device or counts.dtype != torch.int32 \
            or tuple(counts.shape) != (c, t_total) \
            or not counts.is_contiguous():
        raise ValueError("counts must be contiguous int32 (C, T) on the "
                         "kernel's device")


def _check_forward_outputs(device, c: int, t_total: int, rgb, tfin, done,
                           grad_rgb, grad_alpha, h: int, w: int,
                           tile: int) -> None:
    """The forward's outputs and the pixel gradients a backward route
    takes."""
    for name, x, shape, dtype in (
            ("rgb", rgb, (c, h, w, 3), torch.float32),
            ("tfin", tfin, (c * t_total, tile * tile), torch.float32),
            ("done", done, (c * t_total,), torch.int32),
            ("grad_rgb", grad_rgb, (c, h, w, 3), torch.float32),
            ("grad_alpha", grad_alpha, (c, h, w), torch.float32)):
        if x.device != device or x.dtype != dtype \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} {shape} on "
                             f"the kernel's device, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _check_inputs(name: str, entries: torch.Tensor, counts: torch.Tensor,
                  h: int, w: int, tile: int, tw: int, th: int) -> None:
    """What both kernels' entries routes take: raise ValueError on anything
    else."""
    if not entries.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if entries.dtype != torch.float32 or entries.dim() != 4 \
            or entries.shape[-1] != 9 or not entries.is_contiguous():
        raise ValueError("entries must be contiguous float32 (C, T, K, 9), "
                         f"got {entries.dtype} {tuple(entries.shape)}")
    _check_tiles(*entries.shape[:2], counts, entries.device, h, w, tile, tw,
                 th)


def _fwd_outputs(dev, c: int, t_total: int, h: int, w: int, tile: int):
    """The forward kernel's outputs, uninitialised: rgb, alpha, tfin,
    done."""
    return (torch.empty((c, h, w, 3), dtype=torch.float32, device=dev),
            torch.empty((c, h, w), dtype=torch.float32, device=dev),
            torch.empty((c * t_total, tile * tile), dtype=torch.float32,
                        device=dev),
            torch.empty((c * t_total,), dtype=torch.int32, device=dev))


def composite_tiles_cuda(entries: torch.Tensor, counts: torch.Tensor,
                         h: int, w: int, tile: int, tw: int, th: int):
    """Launch the CUDA compositing kernel. Returns rgb (C, H, W, 3), alpha
    (C, H, W), tfin (C*T, tile*tile) and done (C*T,) int32."""
    _check_inputs("composite_tiles_cuda", entries, counts, h, w, tile, tw,
                  th)
    c, t_total, k, _ = entries.shape
    dev = entries.device
    rgb, alpha, tfin, done = _fwd_outputs(dev, c, t_total, h, w, tile)
    with torch.cuda.device(dev):
        launch("composite_fwd", entries.data_ptr(), counts.data_ptr(),
               rgb.data_ptr(), alpha.data_ptr(), tfin.data_ptr(),
               done.data_ptr(), c * t_total, k, tile, tw, th, h, w,
               torch.cuda.current_stream(dev).cuda_stream)
    composite_tiles_cuda.launches += 1
    return rgb, alpha, tfin, done


composite_tiles_cuda.launches = 0


def composite_tiles_bwd_plain(entries: torch.Tensor, counts: torch.Tensor,
                              done: torch.Tensor, grad_rgb: torch.Tensor,
                              grad_alpha: torch.Tensor, h: int, w: int,
                              tile: int, tw: int, th: int, chunk: int = BATCH
                              ) -> torch.Tensor:
    """The backward kernel's plain version: d(rgb, alpha)/d(entries) of
    `composite_tiles_plain` against grad_rgb (C, H, W, 3) and grad_alpha
    (C, H, W), with the slots at or past ``done * 128`` (the batches the
    forward kernel did not process; done (C*T,)) set to zero. Returns
    (C, T, K, 9)."""
    c, t_total, k, _ = entries.shape
    e = entries.detach().requires_grad_(True)
    with torch.enable_grad():
        rgb, alpha = composite_tiles_plain(e, counts, h, w, tile, tw, th,
                                           chunk)
        (grad,) = torch.autograd.grad((rgb, alpha), e,
                                      (grad_rgb, grad_alpha))
    reached = (torch.arange(k, device=e.device)
               < done.reshape(c, t_total, 1).long() * BATCH)
    return grad * reached[..., None]


def composite_tiles_bwd_cuda(entries: torch.Tensor, counts: torch.Tensor,
                             rgb: torch.Tensor, tfin: torch.Tensor,
                             done: torch.Tensor, grad_rgb: torch.Tensor,
                             grad_alpha: torch.Tensor, h: int, w: int,
                             tile: int, tw: int, th: int) -> torch.Tensor:
    """Launch the CUDA backward kernel on the forward kernel's outputs
    (rgb (C, H, W, 3), tfin (C*T, tile*tile), done (C*T,)) and the pixel
    gradients grad_rgb (C, H, W, 3), grad_alpha (C, H, W). Returns
    grad_entries (C, T, K, 9), zero at the slots the forward did not
    process."""
    _check_inputs("composite_tiles_bwd_cuda", entries, counts, h, w, tile,
                  tw, th)
    c, t_total, k, _ = entries.shape
    dev = entries.device
    _check_forward_outputs(dev, c, t_total, rgb, tfin, done, grad_rgb,
                           grad_alpha, h, w, tile)
    grad = torch.zeros_like(entries)
    with torch.cuda.device(dev):
        launch("composite_bwd", entries.data_ptr(), counts.data_ptr(),
               done.data_ptr(), rgb.data_ptr(), tfin.data_ptr(),
               grad_rgb.data_ptr(),
               grad_alpha.data_ptr(), grad.data_ptr(), c * t_total, k, tile,
               tw, th, h, w, torch.cuda.current_stream(dev).cuda_stream)
    composite_tiles_bwd_cuda.launches += 1
    return grad


composite_tiles_bwd_cuda.launches = 0


class CompositeTiles(torch.autograd.Function):
    """Compositing on the card with its gradient: the forward kernel, which
    also records each tile's final transmittance and processed batches,
    and the backward kernel, which walks the same batches again (the port
    of the JAX package's custom_vjp around the two Pallas kernels)."""

    nonfinite = 0

    @staticmethod
    def forward(ctx, entries, counts, h, w, tile, tw, th):
        rgb, alpha, tfin, done = composite_tiles_cuda(entries, counts, h, w,
                                                      tile, tw, th)
        ctx.save_for_backward(entries, counts, rgb, tfin, done)
        ctx.shape = (h, w, tile, tw, th)
        return rgb, alpha

    @staticmethod
    def backward(ctx, grad_rgb: Optional[torch.Tensor],
                 grad_alpha: Optional[torch.Tensor]):
        entries, counts, rgb, tfin, done = ctx.saved_tensors
        h, w, tile, tw, th = ctx.shape
        c = entries.shape[0]
        if grad_rgb is None:
            grad_rgb = entries.new_zeros((c, h, w, 3))
        if grad_alpha is None:
            grad_alpha = entries.new_zeros((c, h, w))
        grad = composite_tiles_bwd_cuda(
            entries, counts, rgb, tfin, done, grad_rgb.float().contiguous(),
            grad_alpha.float().contiguous(), h, w, tile, tw, th)
        # a 0-dim device tensor once added to: no wait for the card
        CompositeTiles.nonfinite += (~torch.isfinite(grad)).sum()
        return grad, None, None, None, None, None, None


def composite_tiles(entries: torch.Tensor, counts: torch.Tensor, h: int,
                    w: int, tile: int, tw: int, th: int, chunk: int = BATCH
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rgb (C, H, W, 3), alpha (C, H, W), differentiable in ``entries``:
    the CUDA kernels for CUDA tensors, the plain version for CPU tensors."""
    if entries.is_cuda:
        return CompositeTiles.apply(entries, counts, h, w, tile, tw, th)
    if entries.device.type == "cpu":
        return composite_tiles_plain(entries, counts, h, w, tile, tw, th,
                                     chunk)
    raise ValueError(f"no compositing for device {entries.device}")


# ---------------------------------------------------------------------------
# The packed routes: the entry gather as the kernels' staging.

def slot_valid(gidx: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(C, T, K) bool: slot k of tile t holds an entry, k < counts[c, t];
    the binning's ent_valid, exactly (its counts are the occupancies capped
    at K)."""
    k = gidx.shape[-1]
    return (torch.arange(k, device=gidx.device)
            < counts.to(gidx.device).long()[..., None])


def _check_packed(name: str, packed: torch.Tensor, gidx: torch.Tensor,
                  counts: torch.Tensor, h: int, w: int, tile: int, tw: int,
                  th: int) -> None:
    """What both packed routes take: raise ValueError on anything else."""
    if not packed.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    if packed.dtype != torch.float32 or packed.dim() != 2 \
            or packed.shape[1] != 9 or not packed.is_contiguous():
        raise ValueError("packed must be contiguous float32 (R, 9), got "
                         f"{packed.dtype} {tuple(packed.shape)}")
    if gidx.device != packed.device or gidx.dtype != torch.int32 \
            or gidx.dim() != 3 or not gidx.is_contiguous():
        raise ValueError("gidx must be contiguous int32 (C, T, K) on "
                         f"packed's device, got {gidx.dtype} "
                         f"{tuple(gidx.shape)} on {gidx.device}")
    _check_tiles(*gidx.shape[:2], counts, packed.device, h, w, tile, tw, th)


def composite_packed_cuda(packed: torch.Tensor, gidx: torch.Tensor,
                          counts: torch.Tensor, h: int, w: int, tile: int,
                          tw: int, th: int):
    """Launch the forward kernel's packed route. Returns rgb (C, H, W, 3),
    alpha (C, H, W), tfin (C*T, tile*tile) and done (C*T,) int32, equal bit
    for bit to `composite_tiles_cuda` on the gathered entries."""
    _check_packed("composite_packed_cuda", packed, gidx, counts, h, w, tile,
                  tw, th)
    c, t_total, k = gidx.shape
    dev = packed.device
    rgb, alpha, tfin, done = _fwd_outputs(dev, c, t_total, h, w, tile)
    with torch.cuda.device(dev):
        launch("composite_fwd_packed", packed.data_ptr(), gidx.data_ptr(),
               counts.data_ptr(), rgb.data_ptr(), alpha.data_ptr(),
               tfin.data_ptr(), done.data_ptr(), c * t_total, k, tile, tw,
               th, h, w, torch.cuda.current_stream(dev).cuda_stream)
    composite_packed_cuda.launches += 1
    return rgb, alpha, tfin, done


composite_packed_cuda.launches = 0


def composite_packed_bwd_plain(packed: torch.Tensor, gidx: torch.Tensor,
                               counts: torch.Tensor, done: torch.Tensor,
                               grad_rgb: torch.Tensor,
                               grad_alpha: torch.Tensor, h: int, w: int,
                               tile: int, tw: int, th: int,
                               chunk: int = BATCH) -> torch.Tensor:
    """The packed backward's plain version: `composite_tiles_bwd_plain` on
    the gathered entries (zero at the slots the forward kernel did not
    process, per ``done``), ``index_add_``-ed into a (C*N, 9) zero table at
    the rows the valid slots came from. Returns (C*N, 9)."""
    valid = slot_valid(gidx, counts)
    entries = gather_entries_plain(packed.detach(), gidx, valid)
    grad = composite_tiles_bwd_plain(entries, counts, done, grad_rgb,
                                     grad_alpha, h, w, tile, tw, th, chunk)
    out = torch.zeros_like(packed, dtype=torch.float32)
    out.index_add_(0, gidx.reshape(-1),
                   (grad * valid[..., None]).reshape(-1, 9))
    return out


def packed_csr(gidx: torch.Tensor, counts: torch.Tensor, rows: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each table row's slots, as the row-sum kernel reads them: (order
    (C*T*K,) int32, offsets (rows + 1,) int32), row r's slots
    order[offsets[r]:offsets[r + 1]] in ascending slot position (the order
    of the JAX package's ``bw_idx``, its binning's second sort) and the
    slots at or past each tile's count after offsets[rows]. The port's
    form of ``Bins.bw_idx``, made from the binning's gidx (C, T, K) and
    counts (C, T)."""
    return masked_csr(gidx.reshape(-1),
                      slot_valid(gidx, counts).reshape(-1), rows)


def composite_packed_slots_cuda(packed: torch.Tensor, gidx: torch.Tensor,
                                counts: torch.Tensor, rgb: torch.Tensor,
                                tfin: torch.Tensor, done: torch.Tensor,
                                grad_rgb: torch.Tensor,
                                grad_alpha: torch.Tensor, h: int, w: int,
                                tile: int, tw: int, th: int) -> torch.Tensor:
    """Launch the backward kernel's packed route on the forward's outputs
    (rgb (C, H, W, 3), tfin (C*T, tile*tile), done (C*T,)) and the pixel
    gradients grad_rgb (C, H, W, 3), grad_alpha (C, H, W). The kernel
    stores each processed slot's gradient into a zero-filled (C*T*K, 9)
    buffer, which is returned: bit for bit the entries route's gradient
    (`composite_tiles_bwd_cuda`) on the gathered entries."""
    _check_packed("composite_packed_slots_cuda", packed, gidx, counts, h, w,
                  tile, tw, th)
    c, t_total, k = gidx.shape
    dev = packed.device
    _check_forward_outputs(dev, c, t_total, rgb, tfin, done, grad_rgb,
                           grad_alpha, h, w, tile)
    slots = torch.zeros((c * t_total * k, 9), dtype=torch.float32,
                        device=dev)
    with torch.cuda.device(dev):
        launch("composite_bwd_packed", packed.data_ptr(), gidx.data_ptr(),
               counts.data_ptr(), done.data_ptr(), rgb.data_ptr(),
               tfin.data_ptr(), grad_rgb.data_ptr(), grad_alpha.data_ptr(),
               slots.data_ptr(), c * t_total, k, tile, tw, th, h, w,
               torch.cuda.current_stream(dev).cuda_stream)
    composite_packed_slots_cuda.launches += 1
    return slots


composite_packed_slots_cuda.launches = 0


def composite_packed_bwd_cuda(packed: torch.Tensor, gidx: torch.Tensor,
                              counts: torch.Tensor, rgb: torch.Tensor,
                              tfin: torch.Tensor, done: torch.Tensor,
                              grad_rgb: torch.Tensor,
                              grad_alpha: torch.Tensor, h: int, w: int,
                              tile: int, tw: int, th: int) -> torch.Tensor:
    """The packed backward: `composite_packed_slots_cuda`'s per-slot
    gradient summed per table row in a fixed order (`packed_csr`, then the
    row-sum kernel, `gather_rows_bwd_cuda`). Returns grad_packed (C*N,
    9)."""
    slots = composite_packed_slots_cuda(packed, gidx, counts, rgb, tfin,
                                        done, grad_rgb, grad_alpha, h, w,
                                        tile, tw, th)
    return gather_rows_bwd_cuda(slots, *packed_csr(gidx, counts,
                                                   packed.shape[0]))


class CompositePacked(torch.autograd.Function):
    """The rasterizer's compositing on the card with its gradient: the
    forward kernel's packed route, which gathers each entry's row from the
    projected table as it stages it, and the backward kernel's packed
    route, which walks the same batches again and stores each slot's
    gradient, summed per table row in a fixed order by the row-sum kernel
    (`composite_packed_bwd_cuda`). The row order (`packed_csr`) is made
    here from the saved gidx and counts, so the render-only paths pay
    nothing for it. Nothing of size (C, T, K, 9) is saved; the slots'
    (C*T*K, 9) gradient lives through the backward."""

    nonfinite = 0

    @staticmethod
    def forward(ctx, packed, gidx, counts, h, w, tile, tw, th):
        rgb, alpha, tfin, done = composite_packed_cuda(packed, gidx, counts,
                                                       h, w, tile, tw, th)
        ctx.save_for_backward(packed, gidx, counts, rgb, tfin, done)
        ctx.shape = (h, w, tile, tw, th)
        return rgb, alpha

    @staticmethod
    def backward(ctx, grad_rgb: Optional[torch.Tensor],
                 grad_alpha: Optional[torch.Tensor]):
        packed, gidx, counts, rgb, tfin, done = ctx.saved_tensors
        h, w, tile, tw, th = ctx.shape
        c = gidx.shape[0]
        if grad_rgb is None:
            grad_rgb = packed.new_zeros((c, h, w, 3))
        if grad_alpha is None:
            grad_alpha = packed.new_zeros((c, h, w))
        grad = composite_packed_bwd_cuda(
            packed, gidx, counts, rgb, tfin, done,
            grad_rgb.float().contiguous(), grad_alpha.float().contiguous(),
            h, w, tile, tw, th)
        # a 0-dim device tensor once added to: no wait for the card
        CompositePacked.nonfinite += (~torch.isfinite(grad)).sum()
        return grad, None, None, None, None, None, None, None


def composite_packed(packed: torch.Tensor, gidx: torch.Tensor,
                     counts: torch.Tensor, h: int, w: int, tile: int,
                     tw: int, th: int, chunk: int = BATCH
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rgb (C, H, W, 3), alpha (C, H, W) of the entries ``packed[gidx]``
    (slots below each tile's count), differentiable in ``packed``: the
    packed CUDA routes for CUDA tensors, the plain gather and compositing
    for CPU tensors."""
    if packed.is_cuda:
        return CompositePacked.apply(packed, gidx, counts, h, w, tile, tw,
                                     th)
    if packed.device.type == "cpu":
        entries = gather_entries_plain(packed, gidx,
                                       slot_valid(gidx, counts))
        return composite_tiles_plain(entries, counts, h, w, tile, tw, th,
                                     chunk)
    raise ValueError(f"no compositing for device {packed.device}")
