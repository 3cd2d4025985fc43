"""Stateful Scene facade (port of `starst3r_tpu/scene.py`; reference
starster/scene.py:18-183): the incremental reconstruction (images, poses,
intrinsics, dense points) and the 3DGS state, with the reference's
surface: `add_images`, `init_3dgs`, `render_3dgs`, `render_3dgs_original`,
`dense_pts_flat`, `dense_cols_flat`, `w2c`.

`add_images` re-runs reconstruction over ALL images, warm-starting the GA
from the previous `optim_params`, then replaces poses and points wholesale;
the content-addressed pair cache skips pairs already inferred.
"""

from __future__ import annotations

import tempfile
from typing import Any, List, Optional

import numpy as np
import torch

from .config import Config, default_config
from .models.mast3r import Mast3rModel
from .reconstruct import Reconstruction, reconstruct_scene
from .utils.device import resolve_device
from .utils.metrics import MetricsLogger
from .utils.se3 import se3_inverse

__all__ = ("Scene",)


class Scene:
    """A scene on one device: ``device="cuda"`` (the default) or "cpu"."""

    def __init__(self, cache_dir: Optional[str] = None, device="cuda",
                 config: Optional[Config] = None,
                 logger: Optional[MetricsLogger] = None):
        self.device = resolve_device(device)
        self.config = config or default_config()
        self.cache_dir = cache_dir or tempfile.mkdtemp(prefix="starst3r_")
        self.logger = logger

        self.raw_imgs: List[np.ndarray] = []   # processed (3, H, W) [-1, 1]
        self.imgs: List[np.ndarray] = []       # display (H, W, 3) [0, 1]
        self.dense_pts: List[np.ndarray] = []
        self.dense_cols: List[np.ndarray] = []
        self.dense_scales: List[np.ndarray] = []
        self.c2w: Optional[np.ndarray] = None
        self.intrinsics: Optional[np.ndarray] = None
        self.optim_params: Optional[Any] = None
        self.reconstruction: Optional[Reconstruction] = None
        self.gs_state: Optional[Any] = None

    @property
    def dense_pts_flat(self) -> np.ndarray:
        """Dense points of all cameras (reference scene.py:79-84)."""
        if not self.dense_pts:
            raise RuntimeError("No dense points available.")
        return np.concatenate(self.dense_pts, axis=0)

    @property
    def dense_cols_flat(self) -> np.ndarray:
        if not self.dense_cols:
            raise RuntimeError("No dense colors available.")
        return np.concatenate(self.dense_cols, axis=0)

    @property
    def w2c(self) -> np.ndarray:
        """World-to-camera matrices (reference scene.py:92-95)."""
        if self.c2w is None:
            raise RuntimeError("No c2w matrix available.")
        return se3_inverse(torch.as_tensor(self.c2w)).numpy()

    def add_images(self, model: Mast3rModel, imgs: List[np.ndarray],
                   conf_thres: float = 1.5, pair_graph: str = "complete"):
        """Add processed (3, H, W) [-1, 1] images and solve poses and dense
        points (reference scene.py:97-155)."""
        self.raw_imgs.extend([np.asarray(im, np.float32) for im in imgs])
        rec, optim_params = reconstruct_scene(
            model, self.raw_imgs, device=self.device,
            optim_params=self.optim_params, tmpdir=self.cache_dir,
            config=self.config, pair_graph=pair_graph, logger=self.logger)
        self.optim_params = optim_params
        self.reconstruction = rec
        self.imgs.extend(rec.imgs[len(self.imgs):])
        self.c2w = rec.cam2w
        self.intrinsics = rec.intrinsics

        pts, depths, confs = rec.get_dense_pts3d(clean_depth=True)
        self.dense_pts, self.dense_cols, self.dense_scales = [], [], []
        for i in range(len(rec.imgs)):
            mask = np.asarray(confs[i]).reshape(-1) > conf_thres
            self.dense_pts.append(np.asarray(pts[i])[mask])
            self.dense_cols.append(rec.imgs[i].reshape(-1, 3)[mask])
            # local point spacing of the full-res grid: depth / focal
            self.dense_scales.append(np.asarray(depths[i]).reshape(-1)[mask]
                                     / float(self.intrinsics[i, 0, 0]))

    def init_3dgs(self, init_scale: float = 3e-3, lr: float = 1e-3,
                  pool_size: int = -1, adaptive_scales: bool = False):
        from .splat import init_3dgs
        return init_3dgs(self, init_scale, lr, pool_size=pool_size,
                         adaptive_scales=adaptive_scales)

    def render_3dgs(self, w2c, intrinsics, width: int, height: int):
        from .splat import render_3dgs
        return render_3dgs(self, w2c, intrinsics, width, height)

    def render_3dgs_original(self, width: int, height: int):
        from .splat import render_3dgs_original
        return render_3dgs_original(self, width, height)
