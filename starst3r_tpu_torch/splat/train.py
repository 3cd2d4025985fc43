"""3DGS initialisation and rendering (port of the init/render half of
`starst3r_tpu/splat/train.py`; reference: starster/gs.py:14-95).

init: one Gaussian per dense point; scales ``init_scale`` (linear), identity
wxyz quats, opacity 1, sh0 and all ``sh_bands`` shN bands = 1 - colour (the
reference's inverted-SH quirk, kept under ``compat_inverted_sh``); an
optional inactive pool tail (opacity 0) for MCMC growth.
render: rasterize with colors = shN and ``sh_degree`` (reference
gs.py:76-87); inactive slots render with opacity 0.

Training (Adam, MCMC, SSIM loss) is the port's next slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import SplatConfig
from ..utils.device import resolve_device
from .rasterize import rasterize

__all__ = ("GSState", "init_gaussians", "render", "render_inputs")


class GSState(NamedTuple):
    params: Dict[str, torch.Tensor]
    n_alive: int              # slots < n_alive are active


def _opacity_act(cfg: SplatConfig):
    """(activation, inverse) raw -> linear opacity."""
    if cfg.compat_raw_activations:
        return (lambda x: x, lambda x: x)
    return (torch.sigmoid, lambda x: torch.log(x) - torch.log1p(-x))


def _scale_act(cfg: SplatConfig):
    if cfg.compat_raw_activations:
        return (lambda x: x, lambda x: x)
    return (torch.exp, torch.log)


def init_gaussians(points: np.ndarray, colors: np.ndarray,
                   cfg: SplatConfig, pool_size: int = 0,
                   point_scales: Optional[np.ndarray] = None,
                   device="cuda") -> GSState:
    """points (N, 3), colors (N, 3) in [0, 1] -> Gaussians on ``device``
    (the card unless "cpu").
    pool_size > N appends inactive capacity; point_scales (N,) or (N, 3)
    overrides the scalar init scale with per-point linear scales."""
    device = resolve_device(device)
    n = points.shape[0]
    cap = max(n, pool_size)
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    cols = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    if cfg.compat_inverted_sh:
        sh_val = 1.0 - cols                     # reference gs.py:29-31
    else:
        sh_val = (cols - 0.5) / 0.28209479177387814
    quats = torch.zeros((n, 4), device=device)
    quats[:, 0] = 1.0
    inv_s = _scale_act(cfg)[1]
    inv_o = _opacity_act(cfg)[1]
    raw_scale = float(inv_s(torch.tensor(cfg.init_scale)))
    raw_op = float(inv_o(torch.tensor(
        1.0 if cfg.compat_raw_activations else 0.95)))
    if point_scales is not None:
        ps = torch.as_tensor(np.asarray(point_scales, np.float32),
                             device=device)
        if ps.ndim == 1:
            ps = ps[:, None]
        scales0 = inv_s(ps.expand(n, 3)).contiguous()
    else:
        scales0 = torch.full((n, 3), raw_scale, device=device)
    params = {
        "means": pts,
        "scales": scales0,
        "quats": quats,
        "opacities": torch.full((n,), raw_op, device=device),
        "sh0": sh_val[:, None, :],
        "shN": sh_val[:, None, :].repeat(1, cfg.sh_bands, 1),
    }
    if not cfg.compat_inverted_sh:
        # rendering reads colors = shN, so the DC term lives in shN[:, 0]
        shn = torch.zeros((n, cfg.sh_bands, 3), device=device)
        shn[:, 0, :] = sh_val
        params["shN"] = shn
    if cap > n:
        pad = cap - n
        params = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                  for k, v in params.items()}
        params["quats"][n:, 0] = 1.0
        params["scales"][n:] = raw_scale
    return GSState(params=params, n_alive=n)


def render_inputs(params: Dict[str, torch.Tensor], cfg: SplatConfig,
                  n_alive: Optional[int] = None):
    """The rasterizer's Gaussian inputs (means, quats, linear scales,
    linear opacities, sh = shN): activations applied, inactive pool slots
    at opacity 0."""
    op = _opacity_act(cfg)[0](params["opacities"])
    sc = _scale_act(cfg)[0](params["scales"])
    if n_alive is not None:
        alive = torch.arange(op.shape[0], device=op.device) < n_alive
        op = torch.where(alive, op, torch.zeros_like(op))
    return params["means"], params["quats"], sc, op, params["shN"]


def render(params: Dict[str, torch.Tensor], w2c, Ks, width: int, height: int,
           cfg: SplatConfig, n_alive: Optional[int] = None):
    """Reference render: colors = shN, sh_degree = cfg.sh_degree. w2c
    (C, 4, 4), Ks (C, 3, 3), arrays or tensors. Returns (rgb (C,H,W,3),
    alpha (C,H,W,1), info)."""
    dev = params["means"].device
    w2c = torch.as_tensor(np.array(w2c, np.float32), device=dev)
    Ks = torch.as_tensor(np.array(Ks, np.float32), device=dev)
    return rasterize(
        *render_inputs(params, cfg, n_alive), w2c, Ks, width, height,
        sh_degree=cfg.sh_degree, tile_size=cfg.tile_size,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        max_per_tile=cfg.max_per_tile, chunk=cfg.chunk)
