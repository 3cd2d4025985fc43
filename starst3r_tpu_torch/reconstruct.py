"""End-to-end reconstruction pipeline (port of `starst3r_tpu/reconstruct.py`):
pairwise inference -> matching -> canonical views -> MST -> condensation ->
two-phase global alignment (reference: starster/reconstruct.py:19-113),
optionally with spectral low-rank depth (``GAConfig.lora_depth``) and an
LM / Schur polish of the poses after it (``GAConfig.refine_lm``).

With a ``mesh`` (`parallel.make_mesh`), every rank calls
`reconstruct_scene` with the same images: the pair batches are split over
the mesh's first axis and the predictions all-gathered; matching, canonical
views, MST, condensation and the GA run on every rank, and rank 0's
canonical views, condensed data and GA result are broadcast, so every rank
holds rank 0's scene even if a stage before the broadcast differed between
ranks in the last bits (the GA itself is repeatable bit for bit on the
card: it adds no atomics); the polish then reduces its correspondence or
track shards over the mesh.

A feed-forward model, `models.vggt.VGGTModel` or `models.fast3r.
Fast3RModel`, takes the feed-forward path instead: one forward over all
views gives each view's camera (VGGT's from its pose encoding, Fast3R's
from its local and global pointmaps) and depth with its confidence
(`infer_scene`); no pairs, no pair cache, no alignment. The
`Reconstruction` then holds that depth and an empty GA state, and
`get_dense_pts3d` unprojects it through the same `_dense_unproject`.

Complete symmetric pair graph, disk-cached pairwise inference, canonical
per-image depth, maximum-spanning-tree pose chain, condensed tensors, the
reference's GA hyperparameters, warm start via ``optim_params``. The network,
matching, canonical reductions, GA and dense unprojection run on ``device``;
the bookkeeping between them (MST, condensation) is host-side numpy.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .alignment import (build_canonical_views, condense, max_spanning_tree,
                        run_global_alignment)
from .alignment.canonical import CanonicalView
from .alignment.ga import GAParams
from .alignment.lm import lm_refine
from .alignment.schur import build_tracks, schur_refine
from .alignment.spectral import spectral_projection_of_depthmaps
from .config import Config, GAConfig, default_config
from .imaging import make_pair_indices, make_sliding_window_pairs
from .io.cache import PairCache, content_key
from .models.fast3r import Fast3RModel
from .models.mast3r import _OUT_KEYS, Mast3rModel, PairPrediction
from .models.vggt import VGGTModel
from .ops.matching import (PairMatches, match_pair, refine_matches,
                           subsample_grid_indices)
from .utils.device import resolve_device
from .utils.metrics import MetricsLogger, Timer
from .utils.profiling import span, trace_if
from .utils.se3 import se3_inverse

__all__ = ("Reconstruction", "reconstruct_scene")


@dataclass
class Reconstruction:
    """Result container (SparseGA analog, reference reconstruct.py:113).

    A feed-forward answer (VGGT, Fast3R) has no alignment: ``core_depth``
    is (C, 0), ``views`` empty, ``subsample`` 0, ``ga_params`` None and
    ``losses`` (nan, nan); its dense depth and confidence are ``depth``
    and ``depth_conf``, which are None after an alignment."""

    imgs: List[np.ndarray]          # (H, W, 3) float in [0, 1]
    cam2w: np.ndarray               # (C, 4, 4)
    intrinsics: np.ndarray          # (C, 3, 3)
    core_depth: np.ndarray          # (C, S) final metric core depth
    views: List[CanonicalView]      # anchors + canonical confidence
    subsample: int
    ga_params: Optional[GAParams]
    losses: Tuple[float, float]
    device: torch.device = torch.device("cpu")
    depth: Optional[np.ndarray] = None        # (C, H, W) feed-forward
    depth_conf: Optional[np.ndarray] = None   # (C, H, W) feed-forward

    @property
    def w2c(self) -> np.ndarray:
        return se3_inverse(torch.as_tensor(self.cam2w)).numpy()

    def get_dense_pts3d(self, clean_depth: bool = True):
        """Per-camera dense world points: (pts list of (H*W, 3), depths list
        of (H*W,), confs list of (H*W,)), as the reference's
        scene.get_dense_pts3d(clean_depth=True) (scene.py:148). The
        span ``recon/dense`` covers a feed-forward answer's unprojection
        (and clean-up), not an alignment's."""
        h, w = self.imgs[0].shape[:2]
        c = len(self.imgs)
        dev = self.device
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        if self.depth is not None:
            with span("recon/dense"):
                pts, depths, confs = _dense_unproject(
                    t(self.depth.reshape(c, -1)), t(self.intrinsics),
                    t(self.cam2w), t(self.depth_conf.reshape(c, -1)), h, w,
                    bool(clean_depth))
                pts, depths, confs = (x.cpu().numpy()
                                      for x in (pts, depths, confs))
            return ([pts[i] for i in range(c)],
                    [depths[i] for i in range(c)],
                    [confs[i] for i in range(c)])
        anchor_idx = np.stack([v.anchor_idx for v in self.views])
        offset = np.stack([v.anchor_offset for v in self.views])
        conf = np.stack([v.conf.reshape(-1) for v in self.views])
        dense_depth = np.take_along_axis(
            np.asarray(self.core_depth), anchor_idx, axis=1) * offset
        pts, depths, confs = _dense_unproject(
            t(dense_depth), t(self.intrinsics), t(self.cam2w), t(conf), h, w,
            bool(clean_depth))
        pts, depths, confs = (x.cpu().numpy() for x in (pts, depths, confs))
        return ([pts[i] for i in range(c)], [depths[i] for i in range(c)],
                [confs[i] for i in range(c)])


def _dense_unproject(dense_depth, K, cam2w, conf, h: int, w: int,
                     clean: bool):
    """Unproject dense depth (C, HW) to world points; with ``clean``, a point
    that lands in front of what another camera sees (by a 5% margin) gets
    confidence 1 (cross-view z-buffer consistency)."""
    c = dense_depth.shape[0]
    dev = dense_depth.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    px = xs.reshape(-1)[None]
    py = ys.reshape(-1)[None]
    x = (px - K[:, 0, 2, None]) / K[:, 0, 0, None] * dense_depth
    y = (py - K[:, 1, 2, None]) / K[:, 1, 1, None] * dense_depth
    cam_pts = torch.stack([x, y, dense_depth], -1)          # (C, HW, 3)
    world = (torch.einsum("cij,cnj->cni", cam2w[:, :3, :3], cam_pts)
             + cam2w[:, None, :3, 3])
    if not clean or c == 1:
        return world, dense_depth, conf

    w2c = se3_inverse(cam2w)
    # p[i, j] = camera i's points in camera j's frame: (C, C, HW, 3)
    p = (torch.einsum("jab,inb->ijna", w2c[:, :3, :3], world)
         + w2c[None, :, None, :3, 3])
    z = p[..., 2]
    zc = torch.clamp(z, min=1e-6)
    kj = K[None, :, None]                                   # (1, C, 1, 3, 3)
    u = kj[..., 0, 0] * p[..., 0] / zc + kj[..., 0, 2]
    v = kj[..., 1, 1] * p[..., 1] / zc + kj[..., 1, 2]
    # torch.round is half-to-even, like jnp.round
    ui = torch.clamp(torch.round(u).long(), 0, w - 1)
    vi = torch.clamp(torch.round(v).long(), 0, h - 1)
    inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z > 1e-6)
    cam_j = torch.arange(c, device=dev)[None, :, None]
    seen = dense_depth.reshape(c, h, w)[cam_j, vi, ui]      # (C, C, HW)
    bad = inside & (z < seen * 0.95)
    not_self = ~torch.eye(c, dtype=torch.bool, device=dev)[:, :, None]
    bad = torch.sum(bad & not_self, dim=1) >= 1              # (C, HW)
    return world, dense_depth, torch.where(bad, torch.ones_like(conf), conf)


def reconstruct_scene(
    model: Union[Mast3rModel, VGGTModel, Fast3RModel],
    imgs: Sequence[np.ndarray],
    filelist: Optional[Sequence[str]] = None,
    device="cuda",
    optim_params: Optional[GAParams] = None,
    tmpdir: Optional[str] = None,
    config: Optional[Config] = None,
    pair_graph: str = "complete",
    window: int = 3,
    freeze: Optional[np.ndarray] = None,
    logger: Optional[MetricsLogger] = None,
    mesh=None,
) -> Tuple[Reconstruction, GAParams]:
    """Run the full reconstruction pipeline on ``device`` (which must be the
    model's device). imgs: processed (3, H, W) images in [-1, 1]. ``mesh``:
    pair-parallel inference and a sharded polish, with the same result on
    every rank (module docstring). ``filelist`` is taken and ignored, as in
    the JAX package (the reference's signature has it; the pair cache is
    keyed by content).

    With a feed-forward model one forward answers (module docstring):
    imgs are (3, H, W) in [0, 1] for a `VGGTModel` (`load_images` with
    ``mode="crop"``), in [-1, 1] for a `Fast3RModel` (`load_images` as for
    MASt3R). It returns (rec, None), and ``optim_params``, ``freeze`` and
    ``mesh`` raise ValueError there, as it has no alignment to
    warm-start, freeze or split."""
    del filelist
    cfg = config or default_config()
    dev = resolve_device(device)
    if dev != model.device:
        raise ValueError(f"model lives on {model.device}, not {dev}")
    timer = Timer()
    n = len(imgs)
    if n < 2:
        raise ValueError("need at least two images")
    imgs = [np.asarray(im, np.float32) for im in imgs]
    h, w = imgs[0].shape[-2:]
    if isinstance(model, (VGGTModel, Fast3RModel)):
        if optim_params is not None or freeze is not None or \
                mesh is not None:
            raise ValueError("a feed-forward reconstruction takes no "
                             "optim_params, freeze or mesh")
        return _feed_forward(model, imgs, timer, logger), None

    if pair_graph == "complete":
        pairs = make_pair_indices(n, symmetric=True)
    elif pair_graph == "sliding":
        pairs = make_sliding_window_pairs(n, window=window, symmetric=True)
    else:
        raise ValueError(pair_graph)

    cache = PairCache(tmpdir or cfg.scene.cache_dir)
    model_tag = _model_tag(model)
    sub = cfg.matching.subsample

    with timer("inference"), trace_if("inference"):
        sharding, batch = None, 8
        if mesh is not None:
            from .parallel import pair_sharding
            sharding = pair_sharding(mesh)
            n_dev = int(mesh.size())
            batch = max(8, n_dev)
            batch -= batch % n_dev
        preds = _cached_inference(model, imgs, pairs, cache, model_tag,
                                  sharding=sharding, batch_size=batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with timer("matching"), span("recon/matching"):
        matches: Dict[Tuple[int, int], PairMatches] = {}
        refined = {} if cfg.matching.anchor_refine else None
        for p in preds:
            m = match_pair(p.desc1, p.desc2, p.conf1, p.conf2, subsample=sub)
            matches[(p.idx1, p.idx2)] = PairMatches(
                *(x.cpu().numpy() for x in m))
            if refined is not None:
                pix1, pix2 = refine_matches(p.desc1, p.desc2, m,
                                            subsample=sub)
                refined[(p.idx1, p.idx2)] = (pix1.cpu().numpy(),
                                             pix2.cpu().numpy())

    # the canonical views and the condensed data, as one span
    with span("recon/condense"):
        with timer("canonical"):
            views, preds_21 = build_canonical_views(
                n, preds, subsample=sub, mode=cfg.matching.canonical_mode)
            scores = np.zeros((n, n))
            for (i, j), m in matches.items():
                scores[i, j] = float(np.sum(m.conf * m.mask))
            mst = max_spanning_tree(scores)

        with timer("condense"):
            data = condense(
                views, matches, preds_21, (h, w), sub,
                cfg.ga.matching_conf_thr,
                max_corres_per_pair=cfg.matching.max_corres_per_pair,
                refined=refined)

    depth_basis = depth_coeffs = None
    if cfg.ga.lora_depth:
        if not cfg.ga.opt_depth:
            warnings.warn(
                "lora_depth without opt_depth freezes the spectral "
                "coefficients: depth is only replaced by its lossy rank-k "
                "approximation. Set GAConfig.opt_depth=True.", stacklevel=2)
        # spectral low-rank depth: a basis from the images' appearance on
        # the core grid, the initial coefficients by least squares against
        # the canonical core depth (host numpy and scipy)
        with timer("lora_basis"):
            grid, hs, ws = subsample_grid_indices(h, w, sub)
            grid = grid.numpy()
            core_colors = np.stack([im.reshape(3, h * w).T[grid]
                                    for im in imgs])          # (C, S, 3)
            depth_coeffs, depth_basis = spectral_projection_of_depthmaps(
                core_colors, np.asarray(data.core_depth), (hs, ws),
                k=cfg.ga.lora_k, gamma=cfg.ga.lora_gamma,
                min_norm=cfg.ga.lora_min_norm)

    with timer("ga"), trace_if("ga"):
        result, params = run_global_alignment(
            data, mst, cfg.ga, prev_params=optim_params, freeze=freeze,
            depth_basis=depth_basis, depth_coeffs=depth_coeffs, device=dev)
        if mesh is not None:
            from .parallel.comm import broadcast_object
            views, data, result, params = broadcast_object(
                (views, data, result, params), dev)
        cam2w_out = result.cam2w.cpu().numpy()
    K_out = result.K.cpu().numpy()

    if cfg.ga.refine_lm:
        # LM / Gauss-Newton polish over absolute poses around the GA's
        # optimum (alignment/lm.py), on the device
        with timer("lm_refine"), trace_if("lm_refine"):
            cam2w_out, K_out, lm_costs = _refine_lm(
                cfg.ga, data, freeze, cam2w_out, K_out,
                result.depth.cpu().numpy(), n, dev, mesh)
        if logger is not None and lm_costs:
            logger.log("lm_refine", cost_first=lm_costs[0],
                       cost_last=lm_costs[-1], iters=len(lm_costs),
                       costs=list(lm_costs))

    if logger is not None:
        logger.log("reconstruct", n_images=n, n_pairs=len(pairs),
                   loss_coarse=result.loss_coarse,
                   loss_fine=result.loss_fine, **timer.summary())

    display = [np.clip(im.transpose(1, 2, 0) * 0.5 + 0.5, 0, 1)
               for im in imgs]
    rec = Reconstruction(
        imgs=display, cam2w=cam2w_out, intrinsics=K_out,
        core_depth=result.depth.cpu().numpy(), views=views, subsample=sub,
        ga_params=params, losses=(result.loss_coarse, result.loss_fine),
        device=dev)
    return rec, params


def _feed_forward(model: Union[VGGTModel, Fast3RModel],
                  imgs: List[np.ndarray], timer: Timer,
                  logger: Optional[MetricsLogger]) -> Reconstruction:
    """One forward over all views -> cameras and dense depth
    (``model.infer_scene``)."""
    n = len(imgs)
    with timer("inference"), trace_if("inference"):
        cam2w, K, depth, conf = (x.cpu().numpy()
                                 for x in model.infer_scene(imgs))
    if logger is not None:
        logger.log("reconstruct", n_images=n, **timer.summary())
    # VGGT's images are in [0, 1], Fast3R's in [-1, 1] as MASt3R's
    if isinstance(model, Fast3RModel):
        display = [np.clip(im.transpose(1, 2, 0) * 0.5 + 0.5, 0, 1)
                   for im in imgs]
    else:
        display = [np.clip(im.transpose(1, 2, 0), 0, 1) for im in imgs]
    return Reconstruction(
        imgs=display,
        cam2w=cam2w, intrinsics=K, core_depth=np.zeros((n, 0), np.float32),
        views=[], subsample=0, ga_params=None,
        losses=(float("nan"), float("nan")), device=model.device,
        depth=depth, depth_conf=conf)


def _refine_lm(ga: GAConfig, data, freeze, cam2w, K, depth, n: int, dev,
               mesh=None):
    """The post-GA polish: correspondences weighted by confidence times
    their pair's matching flag, pairs of two frozen cameras dropped;
    ``ga.lm_mode`` "lm" (pairwise) or "schur" (tracks). Returns (cam2w,
    K with the refined focals, the cost after each iteration)."""
    img1, idx1 = data.corr_img1, data.corr_idx1
    img2, idx2 = data.corr_img2, data.corr_idx2
    conf = data.corr_conf * data.pair_matching_ok[data.corr_pair]
    if freeze is not None:
        freeze = np.asarray(freeze, bool)
        conf = conf * ~(freeze[img1] & freeze[img2])
    conf = conf.astype(np.float32)
    if ga.lm_mode == "schur":
        tracks = build_tracks(img1, idx1, img2, idx2, conf, n,
                              data.core_pix.shape[0], max_obs=ga.lm_max_obs)
        cam2w, focals, costs = schur_refine(
            cam2w, K[:, 0, 0], K[:, :2, 2], depth, data.core_pix, tracks,
            iters=ga.lm_iters, damping=ga.lm_damping, mesh=mesh,
            device=dev)
    elif ga.lm_mode == "lm":
        cam2w, focals, costs = lm_refine(
            cam2w, K[:, 0, 0], K[:, :2, 2], depth, data.core_pix, img1, idx1,
            img2, idx2, conf, iters=ga.lm_iters, damping=ga.lm_damping,
            mesh=mesh, device=dev)
    else:
        raise ValueError(f"lm_mode {ga.lm_mode!r}")
    K = K.copy()
    K[:, 0, 0] = focals
    K[:, 1, 1] = focals
    return cam2w, K, costs


def _model_tag(model: Mast3rModel) -> str:
    """Digest of every tensor of the port's state dict: a per-tensor (sum,
    sum of squares, min, max) fingerprint reduced on the device, hashed with
    each tensor's name, shape and dtype, so the pair cache cannot serve one
    checkpoint's predictions to another."""
    tag = getattr(model, "_tag", None)
    if tag is None:
        sd = model.state_dict()
        with torch.no_grad():
            fp = torch.stack([
                torch.stack([x.sum(), (x * x).sum(), x.min(), x.max()])
                for x in (v.float() for v in sd.values())])
        meta = [(k, tuple(v.shape), str(v.dtype)) for k, v in sd.items()]
        tag = content_key(model.cfg, str(meta),
                          fp.cpu().double().numpy())
        model._tag = tag
    return tag


def _cached_inference(model: Mast3rModel, imgs, pairs, cache: PairCache,
                      model_tag: str, sharding=None, batch_size: int = 8
                      ) -> List[PairPrediction]:
    """Predictions of every pair, from the cache where it holds them.
    Under a ``sharding`` the ranks infer the pairs that some rank misses
    (so all run the same batches), and only rank 0 writes the cache, with a
    barrier after."""
    img_keys = [content_key(np.asarray(im, np.float32)) for im in imgs]
    keys = [content_key(model_tag, img_keys[i], img_keys[j])
            for i, j in pairs]
    hits = [cache.get(key) if cache.dir else None for key in keys]
    writer = True
    if sharding is not None:
        import torch.distributed as dist
        from .parallel.comm import all_reduce
        have = all_reduce(torch.tensor([h is not None for h in hits],
                                       dtype=torch.int32),
                          op=dist.ReduceOp.MIN)
        hits = [h if bool(ok) else None for h, ok in zip(hits, have)]
        writer = dist.get_rank() == 0
    preds: List[Optional[PairPrediction]] = [None] * len(pairs)
    missing = []
    for k, ((i, j), hit) in enumerate(zip(pairs, hits)):
        if hit is not None:
            preds[k] = PairPrediction(idx1=i, idx2=j, **{
                f: torch.as_tensor(hit[f], device=model.device)
                for f in _OUT_KEYS})
        else:
            missing.append(k)
    if missing:
        fresh = model.infer_pairs(imgs, [pairs[k] for k in missing],
                                  batch_size=batch_size, sharding=sharding)
        for k, pred in zip(missing, fresh):
            preds[k] = pred
            if cache.dir and writer:
                cache.put(keys[k], {f: getattr(pred, f).cpu().numpy()
                                    for f in _OUT_KEYS})
        if sharding is not None and cache.dir:
            import torch.distributed as dist
            dist.barrier()
    return preds  # type: ignore[return-value]
