"""Sparse global alignment: two-phase robust optimisation of intrinsics,
poses (MST kinematic chain), per-camera scale and core depth (port of
`starst3r_tpu/alignment/ga.py`; reference starster/reconstruct.py:116-457).

  params     = pps + log_focals + quats + trans + log_sizes + core_depth
  reparam    : cameras centred on their median-depth focal plane; global
               scale pinned by the smallest log-size
  chain      : cam2w composed along the MST
  phase 1    : loss_3d (3D-3D correspondence distance), poses only
  phase 2    : loss_2d (reprojection), + pp/focal (+depth if opt_depth)
  fallback   : loss_dust3r for pairs whose matching conf <= thr, weight 0.01
  optimizer  : Adam (b1, b2) = (0.9, 0.9) written out with optax's state and
               update order (`scale_by_adam` then `scale_by_schedule` of the
               cosine LR), gradients masked per leaf (the moments of a masked
               leaf still decay), quats renormalised every step, and the
               NaN-loss freeze: from the first non-finite loss on, every step
               keeps the previous params, moments and loss
  warm start : previous params overwrite the first N cameras

Each phase walks its ``niter`` steps in chunks of ``GAConfig.jit_chunk``, as
the JAX package's jitted chunks do, and reads the loss to the host once per
chunk. One step is a function of device state only (`_Phase`): the params
as fixed leaf tensors, Adam's moments, the step counter, the freeze flag
and the last finite loss, advanced in place. The LR, the annealing alpha
and Adam's bias correction are computed from the step counter on the
device, and the NaN freeze is a ``where`` that keeps the previous params,
moments and loss once a loss is non-finite, so no step reads the host. On
the CPU the steps run eagerly. On the card the step is captured once per
phase as a CUDA graph and replayed, the counterpart of the JAX package's
jitted ``fori_loop`` chunk; a capture that fails raises. The losses' six
gathers of camera and depth rows (the JAX package's `_gather_rows` sites)
go through `_gather_rows`, whose backward sums each table row's cotangent
rows (`ops/row_sum.py`): on the card a kernel written for it
(`csrc/gather_rows_bwd.cu`: a long row's entries split over a
thread-block cluster, a fixed summation order and no atomics, so a step
gives the same bits every time), on the CPU ``index_add_``. Its indices'
row order (CSR) is built
once a GA call, by `make_state`, outside the captured step. The
correspondences are float32 and the matmuls run at full float32 (no TF32:
the GA has no convolutions and CUDA matmuls default to full precision).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import GAConfig
# the row sum's helpers: the GA's tests and chip_smoke.py find them here
from ..ops.row_sum import (_RowsPlan, _gather_csr,  # noqa: F401
                           _gather_plan, _gather_rows_bwd_in_order,
                           gather_rows_bwd_cuda)
from ..utils.checkpoint import tree_prefix_overwrite
from ..utils.device import resolve_device
from ..utils.schedules import cosine_schedule, meta_gamma_loss
from ..utils.se3 import quat_normalize, quat_to_rotmat, se3_inverse
from .condense import CondensedData

__all__ = ("GAParams", "GAState", "GAResult", "init_params", "make_state",
           "make_K_cam_depth", "run_global_alignment")


class GAParams(NamedTuple):
    """Optimised parameters, stacked over cameras (C = #cameras)."""

    pps: torch.Tensor         # (C, 2) normalised principal points
    log_focals: torch.Tensor  # (C,)
    quats: torch.Tensor       # (C, 4) wxyz, relative rotation along the chain
    trans: torch.Tensor       # (C, 3) relative translation along the chain
    log_sizes: torch.Tensor   # (C,)
    core_depth: torch.Tensor  # (C, S) median-normalised core depth


class GAState(NamedTuple):
    """Static (non-optimised) data for the GA losses."""

    imsizes: torch.Tensor        # (C, 2) (W, H)
    base_focals: torch.Tensor    # (C,)
    median_depths: torch.Tensor  # (C,)
    core_pix: torch.Tensor       # (S, 2)
    corr_img1: torch.Tensor      # (M,) int64
    corr_idx1: torch.Tensor
    corr_img2: torch.Tensor
    corr_idx2: torch.Tensor
    corr_conf: torch.Tensor      # (M,)
    corr_pair: torch.Tensor
    corr_pix1: torch.Tensor      # (M, 2) anchored continuous endpoints
    corr_pix2: torch.Tensor
    corr_doff1: torch.Tensor     # (M,) depth = core_depth[idx] * doff
    corr_doff2: torch.Tensor
    pair_img1: torch.Tensor
    pair_img2: torch.Tensor
    pair_matching_ok: torch.Tensor
    preds21_pts: torch.Tensor
    preds21_conf: torch.Tensor
    edge_parent: Tuple[int, ...]  # MST edges, topological order (host)
    edge_child: Tuple[int, ...]
    root: int
    freeze: torch.Tensor         # (C,) bool
    min_focals: torch.Tensor     # (C,)
    max_focals: torch.Tensor     # (C,)
    # lora_depth: params.core_depth holds (C, k) spectral coefficients and
    # the core depth is basis @ coeffs inside the loss (alignment/spectral)
    depth_basis: Optional[torch.Tensor] = None   # (C, S, k)
    # the losses' gather indices with their row order (`_GatherIndices`),
    # built once by make_state for both phases
    gathers: Optional[Tuple] = None


def init_params(data: CondensedData, device="cuda") -> GAParams:
    c = data.pps.shape[0]
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=device)
    quats = torch.zeros((c, 4), dtype=torch.float32, device=device)
    quats[:, 0] = 1.0
    return GAParams(
        pps=t(data.pps), log_focals=torch.log(t(data.base_focals)),
        quats=quats,
        trans=torch.zeros((c, 3), dtype=torch.float32, device=device),
        log_sizes=torch.zeros((c,), dtype=torch.float32, device=device),
        core_depth=t(data.core_depth))


def make_state(data: CondensedData, mst: Tuple[int, Any], cfg: GAConfig,
               freeze: Optional[np.ndarray] = None,
               depth_basis: Optional[np.ndarray] = None,
               device="cuda") -> GAState:
    c = data.pps.shape[0]
    root, edges = mst
    diags = np.linalg.norm(data.imsizes, axis=1)
    if freeze is None:
        freeze = np.zeros(c, bool)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    i64 = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    m = len(data.corr_idx1)
    state = GAState(
        imsizes=f32(data.imsizes), base_focals=f32(data.base_focals),
        median_depths=f32(data.median_depths), core_pix=f32(data.core_pix),
        corr_img1=i64(data.corr_img1), corr_idx1=i64(data.corr_idx1),
        corr_img2=i64(data.corr_img2), corr_idx2=i64(data.corr_idx2),
        corr_conf=f32(data.corr_conf), corr_pair=i64(data.corr_pair),
        corr_pix1=f32(data.core_pix[data.corr_idx1] if data.corr_pix1 is None
                      else data.corr_pix1),
        corr_pix2=f32(data.core_pix[data.corr_idx2] if data.corr_pix2 is None
                      else data.corr_pix2),
        corr_doff1=f32(np.ones(m) if data.corr_doff1 is None
                       else data.corr_doff1),
        corr_doff2=f32(np.ones(m) if data.corr_doff2 is None
                       else data.corr_doff2),
        pair_img1=i64(data.pair_img1), pair_img2=i64(data.pair_img2),
        pair_matching_ok=torch.as_tensor(np.asarray(data.pair_matching_ok,
                                                    bool), device=device),
        preds21_pts=f32(data.preds21_pts),
        preds21_conf=f32(data.preds21_conf),
        edge_parent=tuple(int(e[0]) for e in edges),
        edge_child=tuple(int(e[1]) for e in edges),
        root=int(root),
        freeze=torch.as_tensor(np.asarray(freeze, bool), device=device),
        min_focals=f32(cfg.min_focal_factor * diags),
        max_focals=f32(cfg.max_focal_factor * diags),
        depth_basis=None if depth_basis is None else f32(depth_basis))
    return state._replace(gathers=_gather_indices(state))


def make_K_cam_depth(params: GAParams, state: GAState,
                     depth_mode: str = "add",
                     shared_intrinsics: bool = False,
                     exp_depth: bool = False):
    """The reparameterisation core (reference reconstruct.py:209-261).
    Returns (K (C,3,3), w2c, cam2w (C,4,4), depth (C,S) core metric depth);
    differentiable in ``params``."""
    c = params.pps.shape[0]
    if shared_intrinsics:
        log_f = params.log_focals.mean().expand(c)
        pps = params.pps.mean(0, keepdim=True).expand(c, 2)
    else:
        log_f = params.log_focals
        pps = params.pps
    focals = torch.minimum(torch.maximum(torch.exp(log_f), state.min_focals),
                           state.max_focals)
    pp_pix = pps * state.imsizes
    zero = torch.zeros_like(focals)
    K = torch.stack([
        torch.stack([focals, zero, pp_pix[:, 0]], -1),
        torch.stack([zero, focals, pp_pix[:, 1]], -1),
        torch.stack([zero, zero, torch.ones_like(focals)], -1)], -2)

    # the optimisation always tries to crush the scale (reconstruct.py:219)
    sizes = torch.exp(params.log_sizes)
    global_scaling = 1.0 / torch.min(sizes)
    z_cameras = sizes * state.median_depths * focals / state.base_focals

    # relative poses -> kinematic chain along the MST
    R = quat_to_rotmat(quat_normalize(params.quats))
    bottom = torch.zeros((c, 1, 4), dtype=R.dtype, device=R.device)
    bottom[:, 0, 3] = 1.0
    rel = torch.cat([torch.cat([R, params.trans[:, :, None]], -1), bottom], 1)
    chain = [None] * c
    chain[state.root] = rel[state.root]
    for p_idx, c_idx in zip(state.edge_parent, state.edge_child):
        chain[c_idx] = chain[p_idx] @ rel[c_idx]
    cam2w_chain = torch.stack(chain)

    # centre each camera on its median-depth focal plane (:240-244)
    ones = torch.ones((c, 1), dtype=R.dtype, device=R.device)
    trans_offset = z_cameras[:, None] * torch.cat(
        [state.imsizes / focals[:, None] * (0.5 - pps), ones], dim=-1)
    new_trans = global_scaling * (
        cam2w_chain[:, :3, 3]
        - torch.einsum("cij,cj->ci", cam2w_chain[:, :3, :3], trans_offset))
    cam2w = torch.cat([torch.cat([cam2w_chain[:, :3, :3],
                                  new_trans[:, :, None]], -1),
                       cam2w_chain[:, 3:, :]], 1)

    core = params.core_depth                      # (C, S) or (C, k)
    if exp_depth:
        # log-space depth: exp BEFORE the lora expansion (reference order)
        core = torch.exp(core)
    if state.depth_basis is not None:
        # lora_depth expansion: a signed k-term sum per core pixel, as an
        # elementwise product and sum so no TF32 matmul can round it
        core = torch.sum(state.depth_basis * core[:, None, :], dim=-1)
    if depth_mode == "add":
        depth = z_cameras[:, None] + (core - 1.0) * (
            state.median_depths * sizes)[:, None]
    elif depth_mode == "mul":
        depth = z_cameras[:, None] * core
    else:
        raise ValueError(depth_mode)
    depth = global_scaling * depth
    return K, se3_inverse(cam2w), cam2w, depth


def _core_pts3d(K, cam2w, depth, state: GAState):
    """Unproject core-grid depth to world points: (C, S, 3)."""
    pix = state.core_pix[None]
    fx = K[:, 0, 0][:, None]
    fy = K[:, 1, 1][:, None]
    cx = K[:, 0, 2][:, None]
    cy = K[:, 1, 2][:, None]
    x = (pix[..., 0] - cx) / fx * depth
    y = (pix[..., 1] - cy) / fy * depth
    cam_pts = torch.stack([x, y, depth], dim=-1)
    return (torch.einsum("cij,csj->csi", cam2w[:, :3, :3], cam_pts)
            + cam2w[:, None, :3, 3])


def _gather_rows_bwd_plain(idx: torch.Tensor, ct: torch.Tensor,
                           nrows: int) -> torch.Tensor:
    """The backward kernel's plain version: d[r] = sum of ct[m] over the
    m with idx[m] == r, (nrows, D). The CPU route and the tests use it."""
    return ct.new_zeros((nrows,) + tuple(ct.shape[1:])).index_add_(0, idx, ct)


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` for a table (R, D) whose backward sums each row's
    cotangent rows with the kernel (CUDA tensors) or ``index_add_`` (CPU
    tensors), the JAX package's `_gather_rows` (its TPU backward is a one-hot
    contraction, which computes the same sum)."""

    @staticmethod
    def forward(ctx, table, idx, order, offsets):
        if table.dim() != 2:
            raise ValueError(f"the table must be (R, D), got {table.shape}")
        ctx.save_for_backward(idx, order, offsets)
        return table[idx]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ct):
        idx, order, offsets = ctx.saved_tensors
        if ct.is_cuda:
            d = gather_rows_bwd_cuda(ct.contiguous(), order, offsets)
        elif ct.device.type == "cpu":
            d = _gather_rows_bwd_plain(idx, ct, offsets.numel() - 1)
        else:
            raise ValueError(f"no row-gather backward for device {ct.device}")
        return d, None, None, None


def _gather_rows(table: torch.Tensor, idx: torch.Tensor,
                 csr: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """``table[idx]`` (M, D), differentiable in ``table``; ``csr`` is
    `_gather_csr(idx, R)`."""
    return _GatherRows.apply(table, idx, *csr)


class _GatherIndices(NamedTuple):
    """The losses' gather indices, each as (idx, its `_gather_csr`): the
    correspondences' depth rows (img * S + idx over the C * S rows of the
    flattened core depth), their cameras, and the pairs' cameras."""

    depth1: Tuple
    depth2: Tuple
    img1: Tuple
    img2: Tuple
    pair_img1: Tuple
    pair_img2: Tuple


def _gather_indices(state: GAState) -> _GatherIndices:
    c, s = state.imsizes.shape[0], state.core_pix.shape[0]
    rows = lambda idx, n: (idx, _gather_csr(idx, n))
    return _GatherIndices(
        depth1=rows(state.corr_img1 * s + state.corr_idx1, c * s),
        depth2=rows(state.corr_img2 * s + state.corr_idx2, c * s),
        img1=rows(state.corr_img1, c), img2=rows(state.corr_img2, c),
        pair_img1=rows(state.pair_img1, c),
        pair_img2=rows(state.pair_img2, c))


def _endpoint_pts(K, cam2w, depth, cam, point, pix, doff):
    """World position of anchored correspondence endpoints (M, 3): the ray
    through ``pix`` at depth core_depth[img, idx] * doff. ``cam`` and
    ``point`` are the endpoints' camera and depth-row gather indices."""
    c, s = depth.shape
    z = _gather_rows(depth.reshape(c * s, 1), *point)[:, 0] * doff
    Km = _gather_rows(K.reshape(c, 9), *cam)
    x = (pix[:, 0] - Km[:, 2]) / Km[:, 0] * z
    y = (pix[:, 1] - Km[:, 5]) / Km[:, 4] * z
    cam_pts = torch.stack([x, y, z], dim=-1)
    Tm = _gather_rows(cam2w.reshape(c, 16), *cam).reshape(-1, 4, 4)
    return torch.einsum("mij,mj->mi", Tm[:, :3, :3], cam_pts) + Tm[:, :3, 3]


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _loss_3d(K, cam2w, depth, state: GAState, gamma: float, alpha,
             ix: _GatherIndices):
    """3D-3D correspondence loss over matching-ok, non-frozen pairs
    (reference reconstruct.py:325-353)."""
    ok = state.pair_matching_ok[state.corr_pair]
    both_frozen = state.freeze[state.corr_img1] & state.freeze[state.corr_img2]
    wgt = state.corr_conf * ok * (~both_frozen)
    p1 = _endpoint_pts(K, cam2w, depth, ix.img1, ix.depth1, state.corr_pix1,
                       state.corr_doff1)
    p2 = _endpoint_pts(K, cam2w, depth, ix.img2, ix.depth2, state.corr_pix2,
                       state.corr_doff2)
    dist = _norm(p1 - p2 + 1e-12)
    loss = torch.sum(wgt * meta_gamma_loss(dist, gamma, alpha))
    return loss / torch.clamp(torch.sum(wgt), min=1e-8)


def _loss_2d(K, cam2w, depth, w2c, state: GAState, gamma: float, alpha,
             ix: _GatherIndices):
    """2D reprojection loss (reference reconstruct.py:355-369): project the
    matched point of image 2 into image 1."""
    ok = state.pair_matching_ok[state.corr_pair]
    wgt = state.corr_conf * ok * (~state.freeze[state.corr_img1])
    proj = K @ w2c[:, :3]                              # (C, 3, 4)
    p2 = _endpoint_pts(K, cam2w, depth, ix.img2, ix.depth2, state.corr_pix2,
                       state.corr_doff2)
    pm = _gather_rows(proj.reshape(-1, 12),
                      *ix.img1).reshape(-1, 3, 4)      # (M, 3, 4)
    homo = torch.einsum("mij,mj->mi", pm[:, :, :3], p2) + pm[:, :, 3]
    z = homo[:, 2:3]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    uv = homo[:, :2] / z
    dist = _norm(uv - state.corr_pix1 + 1e-12)
    loss = torch.sum(wgt * meta_gamma_loss(dist, gamma, alpha))
    return loss / torch.clamp(torch.sum(wgt), min=1e-8)


def _loss_dust3r(pts3d, cam2w, state: GAState, gamma: float,
                 ix: _GatherIndices):
    """Regression fallback for low-matching pairs
    (reference reconstruct.py:283-323)."""
    bad = ~state.pair_matching_ok
    both_frozen = state.freeze[state.pair_img1] & state.freeze[state.pair_img2]
    pair_w = bad & (~both_frozen)
    Tp = _gather_rows(cam2w.reshape(-1, 16), *ix.pair_img2).reshape(-1, 4, 4)
    tgt = (torch.einsum("pij,psj->psi", Tp[:, :3, :3], state.preds21_pts)
           + Tp[:, None, :3, 3])
    c, s = pts3d.shape[0], pts3d.shape[1]
    ours = _gather_rows(pts3d.reshape(c, s * 3),
                        *ix.pair_img1).reshape(-1, s, 3)  # (P, S, 3)
    dist = _norm(ours - tgt + 1e-12)
    wgt = state.preds21_conf * pair_w[:, None]
    loss = torch.sum(wgt * meta_gamma_loss(dist, gamma, 0.0))
    cf = torch.sum(wgt)
    return torch.where(cf > 0, loss / torch.clamp(cf, min=1e-8),
                       torch.zeros_like(loss))


def _trainable_mask(params: GAParams, state: GAState, phase: int,
                    cfg: GAConfig) -> GAParams:
    """Per-leaf 0/1 masks: the reference's requires_grad pattern
    (reconstruct.py:417-437)."""
    free = (~state.freeze).float()
    col = lambda v, like: v[:, None] * torch.ones_like(like)
    if phase == 1:
        return GAParams(
            pps=torch.zeros_like(params.pps),
            log_focals=torch.zeros_like(free),
            quats=col(free, params.quats), trans=col(free, params.trans),
            log_sizes=free, core_depth=torch.zeros_like(params.core_depth))
    return GAParams(
        pps=col(free * float(cfg.opt_pp), params.pps),
        log_focals=free,
        quats=col(free, params.quats), trans=col(free, params.trans),
        log_sizes=free,
        core_depth=col(free * float(cfg.opt_depth), params.core_depth))


# eager steps run on a side stream before a capture (PyTorch's recipe: the
# autograd engine and the libraries set themselves up outside the graph);
# the phase state is restored after them
_WARMUP_STEPS = 3


class _Phase:
    """One phase's device state and its step. The params are leaf tensors
    that stay the same objects for every step (a captured graph reads and
    writes their storage), and every write into the state is an in-place
    ``copy_``. `step` advances the state by one step with no host read,
    as the body of the JAX package's `_optimize_chunk_jit` does."""

    def __init__(self, params: GAParams, state: GAState, niter: int,
                 lr_base: float, lr_end: float, gamma: float, phase: int,
                 cfg: GAConfig):
        self.state, self.cfg = state, cfg
        self.niter, self.lr_base, self.lr_end = niter, lr_base, lr_end
        self.gamma, self.phase = gamma, phase
        self.mask = _trainable_mask(params, state, phase, cfg)
        self.params = GAParams(*[p.detach().clone().requires_grad_(True)
                                 for p in params])
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        dev = params.pps.device
        self.device = dev
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.stopped = torch.zeros((), dtype=torch.bool, device=dev)
        self.last_loss = torch.full((), float("inf"), dtype=torch.float32,
                                    device=dev)

    def tensors(self):
        return [*self.params, *self.mu, *self.nu, self.count, self.stopped,
                self.last_loss]

    def loss(self, alpha):
        state, cfg = self.state, self.cfg
        K, w2c, cam2w, depth = make_K_cam_depth(
            self.params, state, cfg.depth_mode, cfg.shared_intrinsics,
            cfg.exp_depth)
        ix = state.gathers
        if self.phase == 1:
            main = _loss_3d(K, cam2w, depth, state, self.gamma, alpha, ix)
        else:
            main = _loss_2d(K, cam2w, depth, w2c, state, self.gamma, alpha,
                            ix)
        reg = _loss_dust3r(_core_pts3d(K, cam2w, depth, state), cam2w, state,
                           cfg.gamma_d, ix)
        return main + cfg.loss_dust3r_w * reg

    def step(self):
        cfg = self.cfg
        b1, b2, eps = cfg.adam_b1, cfg.adam_b2, 1e-8
        # the schedules' fraction of the phase done, float32 as in JAX
        frac = self.count.to(torch.float32) / max(self.niter, 1)
        loss = self.loss(1.0 - frac)
        grads = torch.autograd.grad(loss, self.params)
        with torch.no_grad():
            lr = cosine_schedule(frac, self.lr_base, self.lr_end)
            n = (self.count + 1).to(torch.float32)
            bc1, bc2 = 1.0 - torch.pow(b1, n), 1.0 - torch.pow(b2, n)
            grads = [g * m for g, m in zip(grads, self.mask)]
            mu = [(1.0 - b1) * g + b1 * v for g, v in zip(grads, self.mu)]
            nu = [(1.0 - b2) * (g * g) + b2 * v
                  for g, v in zip(grads, self.nu)]
            new = GAParams(*[x + (-lr) * ((a / bc1) / (torch.sqrt(b / bc2)
                                                       + eps))
                             for x, a, b in zip(self.params, mu, nu)])
            new = new._replace(quats=quat_normalize(new.quats))
            # NaN freeze (reference reconstruct.py:397-399): from the first
            # non-finite loss on, keep the previous params, moments and loss
            stop = self.stopped | ~torch.isfinite(loss)
            for olds, news in ((self.params, new), (self.mu, mu),
                               (self.nu, nu)):
                for old, upd in zip(olds, news):
                    old.copy_(torch.where(stop, old, upd))
            self.last_loss.copy_(torch.where(stop, self.last_loss, loss))
            self.stopped.copy_(stop)
            self.count.add_(1)

    def steps(self, n: int):
        for _ in range(n):
            self.step()


def _capture(ph: _Phase) -> "torch.cuda.CUDAGraph":
    """Capture one step of ``ph`` as a CUDA graph. The warm-up steps before
    the capture advance the state, and the capture records kernels without
    running them, so the state is put back as it was before the warm-up.
    The capture is begun and ended by hand: `torch.cuda.graph` would also
    synchronise and empty the allocator's caches at every phase, which the
    rest of the pipeline then pays for in fresh allocations."""
    saved = [t.detach().clone() for t in ph.tensors()]
    side = torch.cuda.Stream(ph.device)
    side.wait_stream(torch.cuda.current_stream(ph.device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        ph.steps(_WARMUP_STEPS)
        graph.capture_begin()
        try:
            ph.step()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(ph.device).wait_stream(side)
    with torch.no_grad():
        for t, s in zip(ph.tensors(), saved):
            t.copy_(s)
    _optimize_phase.captures += 1
    return graph


def _optimize_phase(params: GAParams, state: GAState, niter: int,
                    lr_base: float, lr_end: float, gamma: float, phase: int,
                    cfg: GAConfig) -> Tuple[GAParams, float]:
    """One optimisation phase in chunks of ``cfg.jit_chunk`` steps, one
    host read each (the JAX package's `_optimize_phase`). On the CPU the
    steps run eagerly; on the card one step is captured and replayed.
    Returns (params, the last finite loss, inf if there was none)."""
    ph = _Phase(params, state, niter, lr_base, lr_end, gamma, phase, cfg)
    graph = None
    if ph.device.type == "cuda":
        with torch.cuda.device(ph.device):
            graph = _capture(ph)
    chunk = max(int(cfg.jit_chunk), 1)
    loss = float("inf")
    done = 0
    while done < niter:
        n = min(chunk, niter - done)
        if graph is None:
            ph.steps(n)
        else:
            for _ in range(n):
                graph.replay()
            _optimize_phase.replays += n
        # the chunk's one host read: the last finite loss and the step
        # counter, which must have advanced by exactly the chunk
        loss, count = torch.stack([ph.last_loss,
                                   ph.count.to(torch.float32)]).tolist()
        _optimize_phase.host_reads += 1
        done += n
        if int(count) != done:
            raise RuntimeError(f"GA phase {phase}: the device ran {count} "
                               f"steps where the host counted {done}")
    if graph is not None:
        graph.reset()
    return GAParams(*[p.detach() for p in ph.params]), loss


# host reads of the phases' chunks, and, on the card, the captured steps and
# their replays
_optimize_phase.host_reads = 0
_optimize_phase.captures = 0
_optimize_phase.replays = 0


class GAResult(NamedTuple):
    K: torch.Tensor          # (C, 3, 3)
    w2c: torch.Tensor        # (C, 4, 4)
    cam2w: torch.Tensor      # (C, 4, 4)
    depth: torch.Tensor      # (C, S) core metric depth
    pts3d: torch.Tensor      # (C, S, 3) core world points
    loss_coarse: float
    loss_fine: float


def run_global_alignment(
    data: CondensedData,
    mst: Tuple[int, Any],
    cfg: GAConfig,
    prev_params: Optional[GAParams] = None,
    freeze: Optional[np.ndarray] = None,
    depth_basis: Optional[np.ndarray] = None,
    depth_coeffs: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[GAResult, GAParams]:
    """Full two-phase GA with optional warm start: ``prev_params`` (from a
    previous call, possibly with fewer cameras) overwrites the first N
    cameras' parameters. ``depth_basis`` / ``depth_coeffs`` ((C, S, k),
    (C, k), from `spectral.spectral_projection_of_depthmaps`) switch on the
    lora_depth parameterisation. Runs on ``device`` (the card unless
    "cpu")."""
    device = resolve_device(device)
    state = make_state(data, mst, cfg, freeze, depth_basis=depth_basis,
                       device=device)
    params = init_params(data, device=device)
    if depth_basis is not None:
        if depth_coeffs is None:
            raise ValueError("depth_basis requires depth_coeffs")
        params = params._replace(core_depth=torch.as_tensor(
            np.asarray(depth_coeffs, np.float32), device=device))
    if cfg.exp_depth:
        # log-space depth at init, AFTER the lora substitution
        params = params._replace(core_depth=torch.log(
            torch.clamp(params.core_depth, min=1e-4)))
    if prev_params is not None:
        if tuple(prev_params.core_depth.shape[1:]) != tuple(
                params.core_depth.shape[1:]):
            raise ValueError(
                "prev_params.core_depth trailing shape "
                f"{tuple(prev_params.core_depth.shape[1:])} != current "
                f"{tuple(params.core_depth.shape[1:])}: the previous run used "
                "another depth parameterisation (lora_depth / lora_k); keep "
                "the GA depth config fixed across add_images calls")
        params = GAParams(*tree_prefix_overwrite(tuple(params),
                                                 tuple(prev_params)))

    loss1 = float("nan")
    if cfg.niter1:
        params, loss1 = _optimize_phase(params, state, cfg.niter1, cfg.lr1,
                                        cfg.lr_end, cfg.gamma1, 1, cfg)
    loss2 = float("nan")
    if cfg.niter2:
        params, loss2 = _optimize_phase(params, state, cfg.niter2, cfg.lr2,
                                        cfg.lr_end, cfg.gamma2, 2, cfg)
    with torch.no_grad():
        K, w2c, cam2w, depth = make_K_cam_depth(
            params, state, cfg.depth_mode, cfg.shared_intrinsics,
            cfg.exp_depth)
        pts3d = _core_pts3d(K, cam2w, depth, state)
    return GAResult(K=K, w2c=w2c, cam2w=cam2w, depth=depth, pts3d=pts3d,
                    loss_coarse=loss1, loss_fine=loss2), params
