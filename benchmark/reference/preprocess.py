"""Plain reference of the photo preprocessing MASt3R's image loader does
(naver/dust3r `load_images` at `size`, long edge): bicubic resize of the
longest edge to ``size``, centre crop of each side down to a multiple of
16, normalisation to [-1, 1]. PIL and numpy only."""

from __future__ import annotations

import numpy as np
from PIL import Image
from PIL.ImageOps import exif_transpose


def load(path, size: int, crop_multiple: int = 16) -> np.ndarray:
    """(3, H', W') float32 in [-1, 1]."""
    img = exif_transpose(Image.open(path)).convert("RGB")
    w, h = img.size
    scale = size / max(h, w)
    nh, nw = int(h * scale), int(w * scale)
    arr = np.asarray(img.resize((nw, nh), Image.BICUBIC))
    cy, cx = nh // 2, nw // 2
    hh = (cy // crop_multiple) * crop_multiple
    hw = (cx // crop_multiple) * crop_multiple
    arr = arr[cy - hh:cy + hh, cx - hw:cx + hw].astype(np.float32) / 255.0
    return np.ascontiguousarray(((arr - 0.5) / 0.5).transpose(2, 0, 1))
