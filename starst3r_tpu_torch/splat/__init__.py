"""3D Gaussian Splatting, reference-compat surface (`starster.gs`:
init_3dgs / render_3dgs / render_3dgs_original / run_3dgs_optim, reference
starster/gs.py:1-166)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..config import SplatConfig
from .composite import (composite_packed, composite_tiles,
                        composite_tiles_plain)
from .gather import gather_entries
from .mcmc import MCMCConfig, add_position_noise, relocate_dead
from .rasterize import (Bins, bin_gaussians, project_gaussians, rasterize,
                        sh_eval, tile_entries)
from .train import (GSState, init_gaussians, render, run_optim,
                    train_step)

__all__ = (
    "init_3dgs", "render_3dgs", "render_3dgs_original", "run_3dgs_optim",
    "GSState", "init_gaussians", "render", "run_optim", "train_step",
    "rasterize", "project_gaussians", "sh_eval", "tile_entries", "Bins",
    "bin_gaussians", "composite_packed", "composite_tiles",
    "composite_tiles_plain", "gather_entries", "MCMCConfig", "relocate_dead",
    "add_position_noise", "SplatConfig",
)


def init_3dgs(scene, init_scale: float = 3e-3, lr: float = 1e-3,
              pool_size: int = -1, adaptive_scales: bool = False):
    """Initialise splats from the scene's dense points on the scene's device
    (reference: starster/gs.py:14-45). The default pool_size (-1) reserves
    min(cap_max, pool_headroom * N) slots; adaptive_scales seeds each splat
    at its local point spacing (Scene.dense_scales)."""
    cfg = scene.config.splat
    if init_scale != cfg.init_scale or lr != cfg.lr:
        cfg = dataclasses.replace(cfg, init_scale=init_scale, lr=lr)
        scene.config = dataclasses.replace(scene.config, splat=cfg)
    pts = scene.dense_pts_flat
    cols = scene.dense_cols_flat
    point_scales = None
    if adaptive_scales and scene.dense_scales:
        point_scales = np.concatenate(scene.dense_scales, axis=0)
    if pool_size < 0:
        pool_size = min(cfg.cap_max, int(cfg.pool_headroom * pts.shape[0]))
    scene.gs_state = init_gaussians(pts, cols, cfg, pool_size=pool_size,
                                    point_scales=point_scales,
                                    device=scene.device)
    return scene.gs_state


def render_3dgs(scene, w2c, intrinsics, width: int, height: int):
    """Render the splats from arbitrary cameras (reference gs.py:47-88).
    w2c (4, 4) or (C, 4, 4); intrinsics (3, 3) or (C, 3, 3)."""
    if scene.gs_state is None:
        raise RuntimeError("call init_3dgs first")
    w2c = np.asarray(torch.as_tensor(w2c).cpu(), np.float32)
    intrinsics = np.asarray(torch.as_tensor(intrinsics).cpu(), np.float32)
    if w2c.ndim == 2:
        w2c = w2c[None]
        intrinsics = intrinsics[None]
    return render(scene.gs_state.params, w2c, intrinsics, width, height,
                  scene.config.splat, n_alive=scene.gs_state.n_alive)


def render_3dgs_original(scene, width: int, height: int):
    """Render from all original cameras (reference gs.py:90-95)."""
    return render_3dgs(scene, scene.w2c, scene.intrinsics, width, height)


def run_3dgs_optim(scene, iters: int, enable_pruning: bool = False,
                   loss_ssim_fac: float = 0.2, loss_opacity_fac: float = 0.01,
                   loss_scale_fac: float = 0.01,
                   verbose: bool = False) -> List[float]:
    """Optimise the splats against the scene's images on the scene's device
    (reference: starster/gs.py:97-166). Returns the loss of every step."""
    if scene.gs_state is None:
        raise RuntimeError("call init_3dgs first")
    cfg = dataclasses.replace(
        scene.config.splat, loss_ssim_fac=loss_ssim_fac,
        loss_opacity_fac=loss_opacity_fac, loss_scale_fac=loss_scale_fac)
    gt = np.stack(scene.imgs)                   # (C, H, W, 3) in [0, 1]
    scene.gs_state, losses = run_optim(
        scene.gs_state, gt, scene.w2c, scene.intrinsics, iters, cfg,
        enable_pruning=enable_pruning, verbose=verbose)
    return losses
