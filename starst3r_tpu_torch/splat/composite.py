"""Per-tile front-to-back alpha compositing: the hand-written CUDA kernel
(`csrc/composite_fwd.cu`, replacing the JAX package's Pallas `_fwd_kernel`)
and its plain torch version.

  - `composite_tiles_plain`: the port of `rasterize._composite_tiles` (the
    JAX package's reference path), batched over cameras, with torch.cumprod
    inside fixed-length chunks and no early exit. The CPU path, and the
    yardstick the kernel is held to on the card.
  - `composite_tiles_cuda`: builds the kernel on first use (nvcc into
    `starst3r_tpu_torch/_build/`, loaded with ctypes), launches it on the
    current stream and counts the launch in `composite_tiles_cuda.launches`.
  - `composite_tiles`: the rasterizer's entry. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise.

Inputs: entries (C, T, K, 9) float32 [mx, my, conic a, b, c, r, g, b, op],
depth-ordered per tile, zero past each tile's count; counts (C, T) int32.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

__all__ = ("composite_tiles", "composite_tiles_cuda", "composite_tiles_plain",
           "build_kernel")

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "composite_fwd.cu"
_BUILD_DIR = _PKG / "_build"


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
    """Plain torch compositing over every entry slot (``counts`` is implied
    by the zero opacity past each tile's count). Returns rgb (C, H, W, 3),
    alpha (C, H, W)."""
    c, t_total, k, _ = entries.shape
    e = entries.reshape(c * t_total, k, 9).float()
    pix_x, pix_y = _tile_pix(tw, th, tile, e.device)
    pix_x = pix_x.repeat(c, 1)[:, None, :]                    # (CT, 1, P)
    pix_y = pix_y.repeat(c, 1)[:, None, :]
    acc_rgb = torch.zeros((c * t_total, tile * tile, 3), device=e.device)
    acc_t = torch.ones((c * t_total, tile * tile), device=e.device)
    for s in range(0, k, chunk):
        ch = e[:, s:s + chunk]                                # (CT, c, 9)
        dx = pix_x - ch[:, :, 0:1]                            # (CT, c, P)
        dy = pix_y - ch[:, :, 1:2]
        sigma = (0.5 * (ch[:, :, 2:3] * dx * dx + ch[:, :, 4:5] * dy * dy)
                 + ch[:, :, 3:4] * dx * dy)
        # clip before the exp, as the JAX reference does
        alpha = ch[:, :, 8:9] * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
        alpha = torch.where((sigma >= 0.0) & (alpha > 1.0 / 255.0),
                            torch.clamp(alpha, max=0.999),
                            torch.zeros_like(alpha))
        cum = torch.cumprod(1.0 - alpha, dim=1)
        cum_excl = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], 1)
        wgt = alpha * cum_excl * acc_t[:, None, :]
        acc_rgb = acc_rgb + torch.einsum("tcp,tcd->tpd", wgt, ch[:, :, 5:8])
        acc_t = acc_t * cum[:, -1]
    rgb = _tiles_to_image(acc_rgb, c, h, w, tile, tw, th)
    alpha = 1.0 - _tiles_to_image(acc_t, c, h, w, tile, tw, th)
    return rgb, alpha


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the composite kernel is built on "
                       "first use and needs the CUDA toolkit")


@functools.lru_cache(maxsize=None)
def _library() -> Tuple[ctypes.CDLL, str]:
    """Build (once per source version) and load the kernel library.
    Returns (library, compiler log)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD_DIR / f"composite_fwd_{digest}.so"
    log = ""
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(_SRC)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.composite_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                  + [ctypes.c_void_p])
    lib.composite_fwd.restype = ctypes.c_int
    return lib, log


def build_kernel() -> str:
    """Build and load the kernel now; returns the compiler's log (empty
    when an up-to-date build was already on disk)."""
    return _library()[1]


def composite_tiles_cuda(entries: torch.Tensor, counts: torch.Tensor,
                         h: int, w: int, tile: int, tw: int, th: int):
    """Launch the CUDA compositing kernel. Returns rgb (C, H, W, 3), alpha
    (C, H, W), tfin (C*T, tile*tile) and done (C*T,) int32."""
    if not entries.is_cuda:
        raise ValueError("composite_tiles_cuda needs CUDA tensors")
    if entries.dtype != torch.float32 or entries.dim() != 4 \
            or entries.shape[-1] != 9 or not entries.is_contiguous():
        raise ValueError("entries must be contiguous float32 (C, T, K, 9), "
                         f"got {entries.dtype} {tuple(entries.shape)}")
    c, t_total, k, _ = entries.shape
    if t_total != tw * th or h > th * tile or w > tw * tile:
        raise ValueError(f"{t_total} tiles do not cover {h}x{w} at "
                         f"{tw}x{th} tiles of {tile}")
    if not 1 <= tile * tile <= 1024:
        raise ValueError(f"tile {tile}: one thread per pixel needs "
                         "tile*tile <= 1024")
    if counts.device != entries.device or counts.dtype != torch.int32 \
            or tuple(counts.shape) != (c, t_total) \
            or not counts.is_contiguous():
        raise ValueError("counts must be contiguous int32 (C, T) on the "
                         "entries' device")
    lib, _ = _library()
    dev = entries.device
    rgb = torch.empty((c, h, w, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((c, h, w), dtype=torch.float32, device=dev)
    tfin = torch.empty((c * t_total, tile * tile), dtype=torch.float32,
                       device=dev)
    done = torch.empty((c * t_total,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.composite_fwd(
            entries.data_ptr(), counts.data_ptr(), rgb.data_ptr(),
            alpha.data_ptr(), tfin.data_ptr(), done.data_ptr(),
            c * t_total, k, tile, tw, th, h, w, stream)
    if err != 0:
        raise RuntimeError(f"composite_fwd launch failed: CUDA error {err}")
    composite_tiles_cuda.launches += 1
    return rgb, alpha, tfin, done


composite_tiles_cuda.launches = 0


def composite_tiles(entries: torch.Tensor, counts: torch.Tensor, h: int,
                    w: int, tile: int, tw: int, th: int, chunk: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """rgb (C, H, W, 3), alpha (C, H, W): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if entries.is_cuda:
        rgb, alpha, _, _ = composite_tiles_cuda(entries, counts, h, w, tile,
                                                tw, th)
        return rgb, alpha
    if entries.device.type == "cpu":
        return composite_tiles_plain(entries, counts, h, w, tile, tw, th,
                                     chunk)
    raise ValueError(f"no compositing for device {entries.device}")
