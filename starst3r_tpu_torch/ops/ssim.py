"""SSIM and PSNR (port of `starst3r_tpu/ops/ssim.py`), matching the
torchmetrics StructuralSimilarityIndexMeasure(data_range=1) semantics the
reference's 3DGS loss uses (reference: starster/gs.py:10,39,129).

The 11-tap Gaussian window (sigma 1.5) is applied separably as two
depthwise convolutions (`F.conv2d` with ``groups=C``), VALID padding. The
public functions keep the JAX package's (B, H, W, C) layout. On the card,
float32 convolutions go through cuDNN in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ("psnr", "ssim", "ssim_per_image")


@functools.lru_cache(maxsize=8)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float32) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / np.sum(g)


def _filter2d(img: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian filter, VALID. img (B, C, H, W); win (K,)."""
    k = win.shape[0]
    c = img.shape[1]
    out = F.conv2d(img, win.reshape(1, 1, k, 1).expand(c, 1, k, 1),
                   groups=c)
    return F.conv2d(out, win.reshape(1, 1, 1, k).expand(c, 1, 1, k),
                    groups=c)


def ssim_per_image(img1: torch.Tensor, img2: torch.Tensor,
                   data_range: float = 1.0, window_size: int = 11,
                   sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03
                   ) -> torch.Tensor:
    """SSIM of each image pair: img1, img2 (B, H, W, C) -> (B,), the mean
    of the SSIM map over space and channels."""
    x = img1.float().permute(0, 3, 1, 2)
    y = img2.float().permute(0, 3, 1, 2)
    win = torch.as_tensor(_gaussian_window(window_size, sigma),
                          device=x.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu1 = _filter2d(x, win)
    mu2 = _filter2d(y, win)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = _filter2d(x * x, win) - mu1_sq
    sigma2_sq = _filter2d(y * y, win) - mu2_sq
    sigma12 = _filter2d(x * y, win) - mu12
    num = (2 * mu12 + c1) * (2 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return torch.mean(num / den, dim=(1, 2, 3))


def ssim(img1: torch.Tensor, img2: torch.Tensor, data_range: float = 1.0,
         window_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM: img1, img2 (H, W, C) or (B, H, W, C) in [0, data_range].
    Returns a scalar, the mean over batch, space and channels."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]
    return torch.mean(ssim_per_image(img1, img2, data_range, window_size,
                                     sigma, k1, k2))


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = torch.mean((img1.float() - img2.float()) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
