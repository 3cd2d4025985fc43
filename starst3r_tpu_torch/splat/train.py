"""3DGS initialisation, rendering and training (port of
`starst3r_tpu/splat/train.py`; reference: starster/gs.py:14-166).

init (gs.py:14-45): one Gaussian per dense point; scales ``init_scale``
(linear), identity wxyz quats, opacity 1, sh0 and all ``sh_bands`` shN
bands = 1 - colour (the reference's inverted-SH quirk, kept under
``compat_inverted_sh``); an optional inactive pool tail (opacity 0) for MCMC
growth; Adam state and a torch.Generator seeded from ``seed``.
render (gs.py:47-95): rasterize with colors = shN and ``sh_degree``;
inactive slots render with opacity 0.
optimize (gs.py:97-166): every step renders all cameras (or a
``camera_batch``); loss per camera 0.8 L1 + 0.2 (1 - SSIM), plus the
opacity and scale regularisers times the camera count (the reference adds
them inside its per-camera loop) and the optional ``anchors`` drift prior;
backward; Adam; MCMC relocation, growth and position noise when pruning is
on.

Adam is written out with optax ``scale_by_adam``'s state (count, mu, nu) and
order (b1 0.9, b2 0.999, eps 1e-8, count incremented before the bias
correction, which is taken in float32) and per-parameter learning rates,
so the MCMC moment reset and the conversion of a JAX state
(`io.from_jax.gs_state_from_jax`) carry over. The step is functional: it
returns new parameter and moment tensors and leaves the old state as it
was.

The JAX package jit-compiles its step with the config as a static argument
and pins the host-only fields (`_graph_cfg`, `_NON_GRAPH_FIELDS`) so they
do not force recompiles; the port runs eagerly and has neither.

`run_optim(mesh=...)` trains Gaussian-sharded (`parallel.shard_gs_state`):
each rank holds rows [r N/W, (r+1) N/W) of the parameters and Adam moments
and a contiguous share of the cameras (none when there are fewer cameras
than ranks). A step all-gathers the parameter rows (one packed table, with
autograd), bins and renders the whole Gaussian set for this rank's cameras
through the same compositing kernels, adds the regularisers of this rank's
rows, reduce-scatters the gradient to the rows' owners and runs Adam on
them; the loss is summed over ranks. Summed over ranks that is the
meshless loss and gradient. The auto-budget's host reads are reduced with
MAX, so every rank grows the same bucket. MCMC makes the meshless run's
draws with the generator every rank holds alike: a refine relocates over
the all-gathered parameters, the position noise of every Gaussian is
drawn, and each rank keeps its rows. The drift-prior anchors are sharded
like the means.

`run_optim` traces its first three steps under `utils.profiling.trace_if` label
``splat_optim`` when a trace directory is set; the stages of a step
(binning, render, loss, backward, adam, mcmc) are torch.profiler ranges
named ``3dgs/<stage>``, and CUDA events when `stage_events` is a list.

Two faults of the reference are reproduced, not fixed, and the tests name
them: `init_gaussians` takes the log of ``point_scales`` under the fixed
activations, so a non-positive scale gives NaN; and after every refine the
drift-prior anchors move to every Gaussian's current mean, not only the
relocated ones'.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import SplatConfig
from ..parallel.comm import AllGatherRows, all_gather_rows, all_reduce
from ..ops.ssim import ssim_per_image
from ..utils.device import resolve_device
from ..utils.profiling import trace_if
from .mcmc import MCMCConfig, add_position_noise, grow_target, relocate_dead
from .rasterize import Bins, bin_gaussians, max_bbox_area, rasterize

__all__ = ("AdamState", "GSState", "adam_init", "adam_update",
           "compute_bins", "init_gaussians", "mcmc_config_from", "render",
           "render_inputs", "run_optim", "train_step")

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

# Set to a list to time the stages of training steps on the card: each
# stage then appends (name, start, end) CUDA events, recorded on the
# current stream. None (the default) records nothing.
stage_events: Optional[List[Tuple[str, torch.cuda.Event,
                                  torch.cuda.Event]]] = None


@contextlib.contextmanager
def _stage(name: str):
    """One stage of a training step: a torch.profiler range named
    ``3dgs/<name>``, and CUDA events when `stage_events` is a list."""
    with record_function("3dgs/" + name):
        if stage_events is None:
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        stage_events.append((name, start, end))


class AdamState(NamedTuple):
    count: int                      # steps taken (optax's ScaleByAdamState)
    mu: Dict[str, torch.Tensor]     # first moments, per parameter
    nu: Dict[str, torch.Tensor]     # second moments


class GSState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: AdamState
    step: int
    generator: torch.Generator     # MCMC draws
    n_alive: int                    # slots < n_alive are active
    # parallel.distributed.GaussShard: the rows params and moments hold
    # when sharded over a mesh, else None
    shard: Optional[object] = None


def _pack(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(n, D): every parameter's row flattened, side by side."""
    return torch.cat([v.reshape(v.shape[0], -1) for v in params.values()],
                     dim=1)


def _unpack(table: torch.Tensor, like: Dict[str, torch.Tensor]
            ) -> Dict[str, torch.Tensor]:
    """`_pack`'s inverse, for tables of any row count."""
    out, col = {}, 0
    for k, v in like.items():
        d = int(np.prod(v.shape[1:]))
        out[k] = table[:, col:col + d].reshape((table.shape[0],)
                                               + tuple(v.shape[1:]))
        col += d
    return out


def _gather_table(state: GSState) -> torch.Tensor:
    """The packed parameters of every rank of a sharded state."""
    return all_gather_rows(_pack(state.params), state.shard.group)


def _full_params(state: GSState) -> Dict[str, torch.Tensor]:
    """Every Gaussian's parameters (all-gathered when sharded)."""
    if state.shard is None:
        return state.params
    return _unpack(_gather_table(state), state.params)


def _max_over(shard, *values: int) -> List[int]:
    """Host integers reduced with MAX over the shard's ranks."""
    if shard is None:
        return list(values)
    return all_reduce(torch.tensor(values, dtype=torch.long), shard.group,
                      op=torch.distributed.ReduceOp.MAX).tolist()


def _opacity_act(cfg: SplatConfig):
    """(activation, inverse) raw -> linear opacity."""
    if cfg.compat_raw_activations:
        return (lambda x: x, lambda x: x)
    return (torch.sigmoid, lambda x: torch.log(x) - torch.log1p(-x))


def _scale_act(cfg: SplatConfig):
    if cfg.compat_raw_activations:
        return (lambda x: x, lambda x: x)
    return (torch.exp, torch.log)


def _learning_rates(cfg: SplatConfig) -> Dict[str, float]:
    """Per-parameter learning rates (None in the config = cfg.lr)."""
    lrs = {"means": cfg.lr_means, "quats": cfg.lr_quats,
           "scales": cfg.lr_scales, "opacities": cfg.lr_opacities,
           "sh0": cfg.lr_sh, "shN": cfg.lr_sh}
    return {k: (cfg.lr if v is None else v) for k, v in lrs.items()}


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


def adam_update(grads: Dict[str, torch.Tensor], state: AdamState,
                params: Dict[str, torch.Tensor], cfg: SplatConfig
                ) -> Tuple[Dict[str, torch.Tensor], AdamState]:
    """One Adam step in optax's order; returns (new params, new state)."""
    count = state.count + 1
    # the bias corrections in float32, as optax computes decay**count
    bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(count))
    bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(count))
    lrs = _learning_rates(cfg)
    new_params, mu, nu = {}, {}, {}
    with torch.no_grad():
        for k, x in params.items():
            g = grads[k]
            mu[k] = (1.0 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
            nu[k] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[k]
            upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + ADAM_EPS)
            new_params[k] = x + upd * (-lrs[k])
    return new_params, AdamState(count, mu, nu)


def mcmc_config_from(cfg: SplatConfig) -> MCMCConfig:
    """The MCMC schedule from the user-facing SplatConfig knobs."""
    return MCMCConfig(cap_max=cfg.cap_max, min_opacity=cfg.mcmc_min_opacity,
                      noise_lr=cfg.mcmc_noise_lr,
                      refine_every=cfg.mcmc_refine_every,
                      refine_start=cfg.mcmc_refine_start,
                      refine_stop=cfg.mcmc_refine_stop,
                      grow_factor=cfg.mcmc_grow_factor)


def init_gaussians(points: np.ndarray, colors: np.ndarray,
                   cfg: SplatConfig, seed: int = 0, pool_size: int = 0,
                   point_scales: Optional[np.ndarray] = None,
                   device="cuda") -> GSState:
    """points (N, 3), colors (N, 3) in [0, 1] -> Gaussians on ``device``
    (the card unless "cpu").
    pool_size > N appends inactive capacity; point_scales (N,) or (N, 3)
    overrides the scalar init scale with per-point linear scales; ``seed``
    seeds the state's generator (the MCMC draws)."""
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
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return GSState(params=params, opt_state=adam_init(params), step=0,
                   generator=gen, n_alive=n)


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


def _as_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


def render(params: Dict[str, torch.Tensor], w2c, Ks, width: int, height: int,
           cfg: SplatConfig, n_alive: Optional[int] = None,
           bins: Optional[Bins] = None):
    """Reference render: colors = shN, sh_degree = cfg.sh_degree. w2c
    (C, 4, 4), Ks (C, 3, 3), arrays or tensors; ``bins``: an optional
    `compute_bins` result to reuse. Returns (rgb (C,H,W,3), alpha
    (C,H,W,1), info)."""
    dev = params["means"].device
    return rasterize(
        *render_inputs(params, cfg, n_alive), _as_f32(w2c, dev),
        _as_f32(Ks, dev), width, height, sh_degree=cfg.sh_degree,
        tile_size=cfg.tile_size,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        max_per_tile=cfg.max_per_tile, chunk=cfg.chunk, bins=bins)


def compute_bins(params: Dict[str, torch.Tensor], w2c, Ks, width: int,
                 height: int, cfg: SplatConfig,
                 n_alive: Optional[int] = None) -> Bins:
    """The tile-binning index structure for `train_step(..., bins=...)`."""
    dev = params["means"].device
    return bin_gaussians(
        *render_inputs(params, cfg, n_alive), _as_f32(w2c, dev),
        _as_f32(Ks, dev), width, height, sh_degree=cfg.sh_degree,
        tile_size=cfg.tile_size,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        max_per_tile=cfg.max_per_tile)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def _scene_max_area(params, w2c, Ks, width, height, cfg, n_alive) -> int:
    dev = params["means"].device
    return int(max_bbox_area(*render_inputs(params, cfg, n_alive),
                             _as_f32(w2c, dev), _as_f32(Ks, dev), width,
                             height, tile_size=cfg.tile_size))


def _autobudget_cfg(state: GSState, w2c, Ks, width, height,
                    cfg: SplatConfig) -> SplatConfig:
    """The smallest power-of-2 tile budgets the scene needs now, for the
    cameras given (for a sharded state, this rank's; the budgets are the
    largest over the ranks). The configured max_tiles_per_gaussian /
    max_per_tile become ceilings; below them nothing is dropped (the loop
    grows the bucket when the scene outgrows it)."""
    params, n_alive, shard = _full_params(state), state.n_alive, state.shard
    area = (_scene_max_area(params, w2c, Ks, width, height, cfg, n_alive)
            if w2c.shape[0] else 0)
    (area,) = _max_over(shard, area)
    mt = min(_next_pow2(max(area, 2)), cfg.max_tiles_per_gaussian)
    mc = 0
    if w2c.shape[0]:
        probe = compute_bins(
            params, w2c, Ks, width, height,
            dataclasses.replace(cfg, max_tiles_per_gaussian=mt),
            n_alive=n_alive)
        mc = int(probe.max_count.max())
    (mc,) = _max_over(shard, mc)
    # floor 128, one batch of the compositing kernels, as the JAX package
    # floors at its kernels' lane width: the same budgets on both sides
    mpt = min(max(_next_pow2(int(mc * 1.25) + 1), 128), cfg.max_per_tile)
    return dataclasses.replace(cfg, max_tiles_per_gaussian=mt,
                               max_per_tile=mpt)


def train_step(state: GSState, gt: torch.Tensor, w2c: torch.Tensor,
               Ks: torch.Tensor, width: int, height: int, cfg: SplatConfig,
               n_cams: int, bins: Optional[Bins] = None,
               anchors: Optional[torch.Tensor] = None,
               gathered: Optional[torch.Tensor] = None
               ) -> Tuple[GSState, torch.Tensor]:
    """One optimisation step over the given cameras. gt (C, H, W, 3) in
    [0, 1], w2c (C, 4, 4), Ks (C, 3, 3) on the state's device. ``bins``: an
    optional `compute_bins` result (rebin_every reuse; gradients stay
    exact). ``anchors``: optional (cap, 3) seed positions for the drift
    prior (cfg.loss_anchor_fac > 0). Returns (new state, loss as a 0-dim
    device tensor).

    For a sharded state (module docstring) the cameras are this rank's
    (C may be 0), ``n_cams`` the count over all ranks, ``anchors`` this
    rank's rows, ``gathered`` an optional `_gather_table` of the state
    made already; the loss returned is the sum over ranks."""
    keys = list(state.params)
    n_alive = state.n_alive
    sh = state.shard
    with torch.enable_grad():
        if sh is None:
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in state.params.items()}
            wrt = [leaves[k] for k in keys]
            lo, hi = 0, leaves["means"].shape[0]
        else:
            # the gradient of the gathered rows is summed over ranks into
            # each owner's block: AllGatherRows' backward reduce-scatters
            table = _pack(state.params).detach().requires_grad_(True)
            leaves = _unpack(AllGatherRows.apply(table, sh.group, gathered),
                             state.params)
            wrt = [table]
            lo, hi = sh.lo, sh.hi
        dev = leaves["means"].device
        with _stage("render"):
            rgb = (render(leaves, w2c, Ks, width, height, cfg,
                          n_alive=n_alive, bins=bins)[0]
                   if gt.shape[0] else None)
        with _stage("loss"):
            if rgb is None:
                loss = leaves["means"].new_zeros(())
            else:
                l1 = torch.mean(torch.abs(gt - rgb), dim=(1, 2, 3))  # (C,)
                ssim_val = ssim_per_image(gt, rgb)                    # (C,)
                per_cam = (l1 * (1 - cfg.loss_ssim_fac)
                           + (1.0 - ssim_val) * cfg.loss_ssim_fac)
                loss = torch.sum(per_cam)
            # the reference adds the regularisers once per camera; means
            # over the alive slots only (this rank's rows when sharded, so
            # the sum over ranks counts each row once)
            alive = (torch.arange(lo, hi, device=dev) < n_alive).float()
            denom = max(float(n_alive), 1.0)
            reg_o = torch.sum(torch.abs(torch.sigmoid(
                leaves["opacities"][lo:hi])) * alive) / denom
            reg_s = torch.sum(torch.abs(torch.exp(leaves["scales"][lo:hi]))
                              * alive[:, None]) / (3.0 * denom)
            loss = loss + n_cams * (cfg.loss_opacity_fac * reg_o
                                    + cfg.loss_scale_fac * reg_s)
            if cfg.loss_anchor_fac > 0.0 and anchors is not None:
                drift = torch.sum((leaves["means"][lo:hi] - anchors) ** 2,
                                  dim=-1)
                loss = loss + cfg.loss_anchor_fac * torch.sum(
                    drift * alive) / denom
        with _stage("backward"):
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    with _stage("adam"):
        if sh is None:
            grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                     for k, g in zip(keys, grads)}
        else:
            grads = _unpack(grads[0], state.params)
        params, opt_state = adam_update(grads, state.opt_state,
                                        state.params, cfg)
    loss = loss.detach()
    if sh is not None:
        loss = all_reduce(loss, sh.group)
    return state._replace(params=params, opt_state=opt_state,
                          step=state.step + 1), loss


def _mcmc_post_step(state: GSState, lr: float, cfg: SplatConfig,
                    mcfg: MCMCConfig, do_refine: bool) -> GSState:
    """After a step: on refine steps grow and relocate (and reset the Adam
    moments of the relocated slots); every step add position noise. A
    sharded state makes the meshless run's draws: a refine relocates over
    the all-gathered parameters, the noise of every Gaussian is drawn, and
    each rank keeps its rows."""
    sh = state.shard
    opt_state, n_alive = state.opt_state, state.n_alive
    with torch.no_grad():
        params = _full_params(state) if do_refine else state.params
        if do_refine:
            n_target = grow_target(n_alive, params["means"].shape[0], mcfg)
            params, relocated = relocate_dead(
                params, _opacity_act(cfg), _scale_act(cfg),
                min_opacity=mcfg.min_opacity, n_alive=n_alive,
                n_target=n_target, generator=state.generator)
            n_alive = n_target
            if sh is not None:
                relocated = relocated[sh.lo:sh.hi]
                params = {k: v[sh.lo:sh.hi] for k, v in params.items()}

            def reset(x):
                m = relocated.reshape((-1,) + (1,) * (x.dim() - 1))
                return torch.where(m, torch.zeros_like(x), x)

            opt_state = opt_state._replace(
                mu={k: reset(v) for k, v in opt_state.mu.items()},
                nu={k: reset(v) for k, v in opt_state.nu.items()})
        eps, rows_alive = None, n_alive
        if sh is not None:
            means = params["means"]
            eps = torch.randn((sh.n, 3), generator=state.generator,
                              device=means.device,
                              dtype=means.dtype)[sh.lo:sh.hi]
            rows_alive = min(max(n_alive - sh.lo, 0), sh.hi - sh.lo)
        params = add_position_noise(params, lr, mcfg.noise_lr,
                                    _opacity_act(cfg), _scale_act(cfg),
                                    n_alive=rows_alive, eps=eps,
                                    generator=state.generator)
    return state._replace(params=params, opt_state=opt_state,
                          n_alive=n_alive)


def run_optim(state: GSState, gt_images, w2c, Ks, iters: int,
              cfg: SplatConfig, enable_pruning: bool = False,
              mcfg: Optional[MCMCConfig] = None,
              verbose: bool = False, mesh=None
              ) -> Tuple[GSState, List[float]]:
    """The reference's run_3dgs_optim loop (gs.py:97-166) on the state's
    device. gt_images (C, H, W, 3) in [0, 1], w2c (C, 4, 4), Ks (C, 3, 3),
    arrays or tensors. mcfg defaults to the schedule in ``cfg``. Returns
    (new state, the loss of every step).

    ``mesh``: train Gaussian-sharded over its first axis (module
    docstring); every rank calls this with the same arguments, and every
    rank gets the whole trained state back. A state sharded already by
    `parallel.shard_gs_state` trains sharded without a mesh."""
    if mcfg is None:
        mcfg = mcmc_config_from(cfg)
    if mesh is not None and state.shard is None:
        from ..parallel.distributed import shard_gs_state
        state = shard_gs_state(state, mesh)
    sh = state.shard
    dev = state.params["means"].device
    gt = _as_f32(gt_images, dev)
    c, h, w = gt.shape[0], gt.shape[1], gt.shape[2]
    w2c_t = _as_f32(w2c, dev)
    ks_t = _as_f32(Ks, dev)
    cb = cfg.camera_batch if 0 < cfg.camera_batch < c else 0

    def mine(cams: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous share of a camera list."""
        if sh is None:
            return cams
        k = cams.shape[0]
        return cams[sh.rank * k // sh.size:(sh.rank + 1) * k // sh.size]

    own = mine(torch.arange(c, device=dev))
    gt_o, w2c_o, ks_o = ((gt, w2c_t, ks_t) if sh is None
                         else (gt[own], w2c_t[own], ks_t[own]))
    step0 = state.step
    cam_rng = np.random.default_rng(step0 + 1)
    # losses stay on the device until the loop ends: one host read at the
    # end, so the host does not wait on the card every step
    losses_dev: List[torch.Tensor] = []
    rebin = max(int(cfg.rebin_every), 1)
    scfg = (_autobudget_cfg(state, w2c_o, ks_o, w, h, cfg)
            if cfg.auto_budget else cfg)
    # bins are reused across steps when rebin > 1 (all cameras); every
    # rank rebins at the same steps, so their collectives pair up
    bins, stale = None, True
    # drift-prior anchors: the seed positions, moved to the current means
    # after every refine (for every Gaussian, as the reference does)
    anchors = (state.params["means"].clone()
               if cfg.loss_anchor_fac > 0.0 else None)
    with contextlib.ExitStack() as trace:
        trace.enter_context(trace_if("splat_optim"))
        for it in range(iters):
            if it == 3:
                # trace only the first steps: a whole run's trace is large
                # and the profiler slows every step it records
                trace.close()
            gathered = None
            if sh is not None:
                with _stage("gather"):
                    gathered = _gather_table(state)
            if cb:
                # minibatches change the cameras every step: no bin reuse
                sel = mine(torch.as_tensor(
                    cam_rng.choice(c, size=cb, replace=False), device=dev))
                state, loss = train_step(state, gt[sel], w2c_t[sel],
                                         ks_t[sel], w, h, scfg, cb,
                                         anchors=anchors, gathered=gathered)
            else:
                if stale or it % rebin == 0:
                    with _stage("binning"):
                        full = (state.params if gathered is None
                                else _unpack(gathered, state.params))
                        bins = (compute_bins(full, w2c_o, ks_o, w, h, scfg,
                                             n_alive=state.n_alive)
                                if len(own) else None)
                        if cfg.auto_budget:
                            scfg, bins = _grow_budget(
                                full, state.n_alive, bins, w2c_o, ks_o, w,
                                h, scfg, cfg, sh)
                    stale = False
                state, loss = train_step(state, gt_o, w2c_o, ks_o, w, h,
                                         scfg, c, bins=bins, anchors=anchors,
                                         gathered=gathered)
            if enable_pruning:
                step = step0 + it + 1
                do_refine = (mcfg.refine_start <= step < mcfg.refine_stop
                             and step % mcfg.refine_every == 0)
                # the noise scales with the means' learning rate, as
                # gsplat's does with the means optimiser's
                mean_lr = (cfg.lr_means if cfg.lr_means is not None
                           else cfg.lr)
                with _stage("mcmc"):
                    state = _mcmc_post_step(state, mean_lr, cfg, mcfg,
                                            do_refine)
                if do_refine:
                    stale = True   # relocated Gaussians jump: rebin
                    if anchors is not None:
                        anchors = state.params["means"].clone()
            losses_dev.append(loss)
            if verbose and (it % 50 == 0 or it == iters - 1):
                print(f"[3dgs] step {step0 + it + 1} "
                      f"loss={float(loss):.4f} alive={state.n_alive}")
    losses = torch.stack(losses_dev).tolist() if losses_dev else []
    if sh is not None:
        from ..parallel.distributed import gather_gs_state
        state = gather_gs_state(state)
    return state, losses


def _grow_budget(params, n_alive: int, bins: Optional[Bins], w2c, Ks,
                 w: int, h: int, scfg: SplatConfig, cfg: SplatConfig,
                 shard=None) -> Tuple[SplatConfig, Optional[Bins]]:
    """Grow a budget bucket the moment the scene outgrows it (nothing is
    dropped below the configured ceilings), rebinning at the new size.
    With ``shard`` the counts are the largest over its ranks (``bins`` is
    None on a rank without cameras)."""
    clipped, mc = (0, 0) if bins is None else (int(bins.n_clipped.max()),
                                               int(bins.max_count.max()))
    clipped, mc = _max_over(shard, clipped, mc)
    grown = scfg
    if (clipped > 0
            and scfg.max_tiles_per_gaussian < cfg.max_tiles_per_gaussian):
        grown = dataclasses.replace(grown, max_tiles_per_gaussian=min(
            scfg.max_tiles_per_gaussian * 2, cfg.max_tiles_per_gaussian))
    if mc > scfg.max_per_tile and scfg.max_per_tile < cfg.max_per_tile:
        grown = dataclasses.replace(grown, max_per_tile=min(
            _next_pow2(int(mc * 1.25) + 1), cfg.max_per_tile))
    if grown is scfg or bins is None:
        return grown, bins
    return grown, compute_bins(params, w2c, Ks, w, h, grown,
                               n_alive=n_alive)
