"""Stateful Scene facade (port of `starst3r_tpu/scene.py`; reference
starster/scene.py:18-183): the incremental reconstruction (images, poses,
intrinsics, dense points) and the 3DGS state, with the reference's
surface: `add_images`, `init_3dgs`, `render_3dgs`, `render_3dgs_original`,
`run_3dgs_optim`, `dense_pts_flat`, `dense_cols_flat`, `w2c`, the held-out
camera registration `register_camera`, and checkpoints (`save`, `load`) in
the JAX package's file format.

`add_images` re-runs reconstruction over ALL images, warm-starting the GA
from the previous `optim_params`, then replaces poses and points wholesale;
the content-addressed pair cache skips pairs already inferred. With a
feed-forward model it runs one forward over all images (no GA to
warm-start): a `VGGTModel` on images in [0, 1] (`load_images(...,
mode="crop")`), a `Fast3RModel` on images in [-1, 1] as MASt3R's.
"""

from __future__ import annotations

import tempfile
from typing import Any, List, Optional, Union

import numpy as np
import torch

from .alignment.ga import GAParams
from .config import Config, default_config
from .models.fast3r import Fast3RModel
from .models.mast3r import Mast3rModel
from .models.vggt import VGGTModel
from .reconstruct import Reconstruction, reconstruct_scene
from .utils.checkpoint import group_flat, load_flat, save_pytree
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

    def add_images(self, model: Union[Mast3rModel, VGGTModel, Fast3RModel],
                   imgs: List[np.ndarray], conf_thres: float = 1.5,
                   pair_graph: str = "complete"):
        """Add processed (3, H, W) images, in [-1, 1] for MASt3R and
        Fast3R and in [0, 1] for VGGT, and solve poses and dense points
        (reference scene.py:97-155)."""
        self.raw_imgs.extend([np.asarray(im, np.float32) for im in imgs])
        self._reconstruct(model, conf_thres, pair_graph, freeze=None)

    def register_camera(self, model: Mast3rModel, img,
                        conf_thres: float = 1.5,
                        pair_graph: str = "complete") -> np.ndarray:
        """Register ONE new image against the existing reconstruction
        without moving it: every earlier camera (pose, intrinsics, depth) is
        frozen and only the new camera's parameters are optimised; the
        held-out camera primitive (a novel view whose image never entered
        training). `add_images` re-optimises every camera jointly, which
        shifts the gauge; freezing keeps the frame, so Gaussians trained in
        it stay valid. Returns the new camera's c2w (4, 4)."""
        n_prev = len(self.raw_imgs)
        if n_prev < 2:
            raise RuntimeError("register_camera needs an existing scene")
        self.raw_imgs.append(np.asarray(img, np.float32))
        freeze = np.zeros(n_prev + 1, bool)
        freeze[:n_prev] = True
        self._reconstruct(model, conf_thres, pair_graph, freeze=freeze)
        return np.asarray(self.c2w[-1])

    def _reconstruct(self, model: Union[Mast3rModel, VGGTModel,
                                        Fast3RModel],
                     conf_thres: float,
                     pair_graph: str, freeze: Optional[np.ndarray]):
        """Reconstruct over all images, warm-started, and replace poses,
        intrinsics and the dense lists wholesale."""
        rec, optim_params = reconstruct_scene(
            model, self.raw_imgs, device=self.device,
            optim_params=self.optim_params, tmpdir=self.cache_dir,
            config=self.config, pair_graph=pair_graph, freeze=freeze,
            logger=self.logger)
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

    def run_3dgs_optim(self, iters: int, enable_pruning: bool = False,
                       loss_ssim_fac: float = 0.2,
                       loss_opacity_fac: float = 0.01,
                       loss_scale_fac: float = 0.01,
                       verbose: bool = False) -> List[float]:
        from .splat import run_3dgs_optim
        return run_3dgs_optim(self, iters, enable_pruning, loss_ssim_fac,
                              loss_opacity_fac, loss_scale_fac, verbose)

    def save(self, path: str):
        """Checkpoint the scene (poses, intrinsics, the processed images
        exactly, the GA's warm-start params, the Gaussians) in the JAX
        package's format (`starst3r_tpu/scene.py:203-225`)."""
        gs = self.gs_state
        state = {
            "c2w": self.c2w, "intrinsics": self.intrinsics,
            # the processed images bit for bit: a loaded scene trains
            # against the same targets and derives the same pair-cache keys
            "raw_imgs": (np.stack(self.raw_imgs).astype(np.float32)
                         if self.raw_imgs else np.zeros((0,), np.float32)),
            "imgs": (np.stack(self.imgs).astype(np.float32)
                     if self.imgs else np.zeros((0,), np.float32)),
            "optim_params": (tuple(self.optim_params)
                             if self.optim_params is not None else ()),
            "gaussians": dict(gs.params) if gs is not None else {},
            "gs_n_alive": np.asarray(gs.n_alive if gs is not None else 0,
                                     np.int32),
        }
        save_pytree(path, state)

    @classmethod
    def load(cls, path: str, cache_dir: Optional[str] = None,
             config: Optional[Config] = None, device="cuda") -> "Scene":
        """Restore a scene written by `save` (by either package) on
        ``device`` (the card unless "cpu"): poses, intrinsics, images, the
        GA's warm-start params and, if present, the Gaussians with a fresh
        Adam state and a generator seeded 0."""
        from .splat.train import GSState, adam_init

        scene = cls(cache_dir=cache_dir, device=device, config=config)
        dev = scene.device
        flat = load_flat(path)
        scene.c2w = np.asarray(flat["c2w"])
        scene.intrinsics = np.asarray(flat["intrinsics"])
        imgs = np.asarray(flat.get("imgs", np.zeros((0,))), np.float32)
        if imgs.ndim == 4:
            scene.imgs = [imgs[i] for i in range(imgs.shape[0])]
        raw = np.asarray(flat.get("raw_imgs", np.zeros((0,))), np.float32)
        if raw.ndim == 4:
            scene.raw_imgs = [raw[i] for i in range(raw.shape[0])]
        elif imgs.ndim == 4:
            # a checkpoint without raw_imgs: rebuild them (approximately)
            scene.raw_imgs = [im.transpose(2, 0, 1) * 2.0 - 1.0
                              for im in scene.imgs]
        op = group_flat(flat, "optim_params")
        if op:
            scene.optim_params = GAParams(*[
                torch.as_tensor(op[str(i)], device=dev)
                for i in range(len(GAParams._fields))])
        gauss = group_flat(flat, "gaussians")
        if gauss:
            params = {k: torch.as_tensor(v, device=dev)
                      for k, v in gauss.items()}
            n_alive = flat.get("gs_n_alive", None)
            if n_alive is None or int(n_alive) <= 0:
                n_alive = params["means"].shape[0]
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            scene.gs_state = GSState(params=params,
                                     opt_state=adam_init(params), step=0,
                                     generator=gen, n_alive=int(n_alive))
        return scene
