"""Image loading and preprocessing (port of `starst3r_tpu/imaging.py`).

Behavioral spec (reference: starster/image.py:25-139): PIL load, EXIF
transpose, RGB; bicubic resize so the longest edge is ``size``; center-crop
H and W down to a multiple of ``crop_multiple``; normalise with mean/std 0.5
to [-1, 1]. Images stay host-side numpy (3, H, W) float32; the pipeline moves
them to the device once per batch. `load_images` resizes, crops and
normalises either in the C++ host runtime (`native`, on a thread pool) or
with PIL and numpy.

``mode="crop"`` is VGGT's own preprocessing instead
(vggt/utils/load_fn.py `load_and_preprocess_images`, mode "crop"): no EXIF
transpose, RGBA composited on white, the width resized to ``size`` (518)
and the height to round(h size / w / 14) 14 by one bicubic resize, a
height past ``size`` centre-cropped to it, values kept in [0, 1] (VGGT
applies the ImageNet mean and std inside the network).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image
from PIL.ImageOps import exif_transpose

from .utils.profiling import span

__all__ = (
    "make_pair_indices",
    "make_sliding_window_pairs",
    "process_image",
    "load_image",
    "load_images",
    "load_image_crop",
    "image_route",
    "image_to_uint8",
)


def make_pair_indices(n: int, symmetric: bool = True) -> List[Tuple[int, int]]:
    """Complete pair graph in the reference's order
    (starster/image.py:25-40): all (i, j) with j < i, then their mirrors."""
    pairs: List[Tuple[int, int]] = []
    for i in range(n):
        for j in range(i):
            pairs.append((i, j))
    if symmetric:
        pairs = pairs + [(j, i) for (i, j) in pairs]
    return pairs


def make_sliding_window_pairs(n: int, window: int = 3,
                              symmetric: bool = True) -> List[Tuple[int, int]]:
    """(i, j) for 0 < i - j <= window, then the mirrors if symmetric."""
    pairs = []
    for i in range(n):
        for j in range(max(0, i - window), i):
            pairs.append((i, j))
    if symmetric:
        pairs = pairs + [(j, i) for (i, j) in pairs]
    return pairs


def _resize_bicubic(img: np.ndarray, new_hw: Tuple[int, int]) -> np.ndarray:
    h, w = new_hw
    if img.dtype != np.uint8:
        arr = np.clip(img, 0.0, 1.0)
        arr = (arr * 255.0 + 0.5).astype(np.uint8)
    else:
        arr = img
    pil = Image.fromarray(arr).resize((w, h), Image.BICUBIC)
    return np.asarray(pil)


def process_image(img: np.ndarray, size: int,
                  crop_multiple: int = 16,
                  mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """(H, W, 3) uint8 (or float in [0, 1]) -> (3, H', W') float32 in
    [-1, 1] (reference: starster/image.py:43-78)."""
    h, w = img.shape[:2]
    scale = size / max(h, w)
    new_h, new_w = int(h * scale), int(w * scale)
    img = _resize_bicubic(img, (new_h, new_w))
    cy, cx = new_h // 2, new_w // 2
    hh = (cy // crop_multiple) * crop_multiple
    wh = (cx // crop_multiple) * crop_multiple
    img = img[cy - hh: cy + hh, cx - wh: cx + wh]
    arr = img.astype(np.float32) / 255.0
    arr = (arr - mean) / std
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


def load_image(path: Union[str, Path], size: int = 224,
               crop_multiple: int = 16) -> np.ndarray:
    """Load + preprocess one file (reference: starster/image.py:81-103)."""
    img = exif_transpose(Image.open(path)).convert("RGB")
    return process_image(np.asarray(img), size, crop_multiple=crop_multiple)


def image_route(impl: Optional[str] = "auto") -> str:
    """The route `load_images` takes for ``impl``: "auto" (or None) picks
    "native" when the C++ library builds here, else "pil", as the JAX
    package's "auto" does; "native" and "pil" are taken as given; anything
    else raises ValueError."""
    if impl in ("auto", None):
        from . import native
        return "native" if native.available() else "pil"
    if impl not in ("native", "pil"):
        raise ValueError(f"impl must be 'auto', 'native' or 'pil', not "
                         f"{impl!r}")
    return impl


# VGGT's patch: the multiple its crop mode rounds the height to
VGGT_PATCH = 14


def load_image_crop(path: Union[str, Path], size: int = 518) -> np.ndarray:
    """VGGT's "crop" preprocessing of one file -> (3, H', W') float32 in
    [0, 1], W' = ``size`` (module docstring)."""
    img = Image.open(path)
    if img.mode == "RGBA":
        white = Image.new("RGBA", img.size, (255, 255, 255, 255))
        img = Image.alpha_composite(white, img)
    img = img.convert("RGB")
    w, h = img.size
    new_h = round(h * (size / w) / VGGT_PATCH) * VGGT_PATCH
    arr = np.asarray(img.resize((size, new_h), Image.BICUBIC))
    if new_h > size:
        top = (new_h - size) // 2
        arr = arr[top:top + size]
    return np.ascontiguousarray(
        (arr.astype(np.float32) / 255.0).transpose(2, 0, 1))


def load_images(paths: Sequence[Union[str, Path]], size: int = 224,
                crop_multiple: int = 16,
                impl: Optional[str] = "auto",
                mode: str = "dust3r") -> List[np.ndarray]:
    """Load a list of files (reference: starster/image.py:105-110).

    impl: "native" decodes with PIL and resizes, crops and normalises in the
    C++ host runtime (`native.preprocess_batch`), and raises RuntimeError
    when that library cannot be built; "pil" is the pure-Python route;
    "auto" (or None) picks as `image_route` says.

    mode: "dust3r" (the above, [-1, 1]) or "crop", VGGT's preprocessing
    (`load_image_crop`, [0, 1]; ``crop_multiple`` unused), which has the
    PIL route alone, on a thread pool of up to 8 (PIL's decoding and
    resizing release the interpreter lock): ``impl="native"`` raises
    ValueError there."""
    if mode == "crop":
        if impl not in ("auto", None, "pil"):
            raise ValueError(f"load_images mode 'crop' has the PIL route "
                             f"alone, not impl {impl!r}")
        with span("imaging/load"):
            workers = max(1, min(len(paths), os.cpu_count() or 1, 8))
            with ThreadPoolExecutor(workers) as pool:
                return list(pool.map(lambda p: load_image_crop(p, size),
                                     paths))
    if mode != "dust3r":
        raise ValueError(f"mode must be 'dust3r' or 'crop', not {mode!r}")
    with span("imaging/load"):
        if image_route(impl) == "native":
            from . import native
            raws = [np.asarray(exif_transpose(Image.open(p)).convert("RGB"))
                    for p in paths]
            return native.preprocess_batch(raws, size,
                                           crop_mult=crop_multiple)
        return [load_image(p, size, crop_multiple=crop_multiple)
                for p in paths]


def image_to_uint8(img: np.ndarray, mean: float = 0.5,
                   std: float = 0.5) -> np.ndarray:
    """Invert the normalisation: (3, H, W) or (H, W, 3) float -> (H, W, 3)
    uint8."""
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[0] == 3:
        arr = arr.transpose(1, 2, 0)
    arr = arr * std + mean
    return np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
