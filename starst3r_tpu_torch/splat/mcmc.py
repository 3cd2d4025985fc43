"""MCMC relocation and growth for Gaussian densification (port of
`starst3r_tpu/splat/mcmc.py`; gsplat's MCMCStrategy, chosen by the
reference at starster/gs.py:41-45).

The pool has a fixed capacity and an alive count: the first ``n_alive``
slots are active.
  - relocation: dead slots (opacity <= min_opacity) move onto live
    Gaussians drawn with probability proportional to opacity;
  - growth (gsplat's add_new_gs, +5% per refine): slots [n_alive, n_target)
    are activated and relocated exactly like dead slots.
Relocated copies and their sources share opacity through
o_new = 1 - (1 - o)^(1/(k+1)) (clamped to [min_opacity, 1 - 1e-6]) and
shrink their scales by sqrt(k+1); the caller resets the Adam moments of the
returned mask. Every step, position noise shaped by each Gaussian's
covariance and gated by its opacity moves the alive slots.

Sampling is split from the math: `sample_targets` draws the categorical
targets and `add_position_noise` the normal noise from a torch.Generator;
`relocate_dead` and `add_position_noise` also take ``targets`` / ``eps``
directly, which is how the tests feed both packages the same draws (a JAX
key and a torch.Generator give different numbers from one seed). On the
card the categorical draw runs under PyTorch's deterministic algorithms:
``torch.multinomial`` draws through a float cumulative sum, and PyTorch's
default one on the card (a scan whose partial sums meet in no fixed
order) gives other bits from call to call past a few thousand entries, so
the same generator state would pick other targets.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .rasterize import quat_to_rotmat_wxyz

__all__ = ("MCMCConfig", "add_position_noise", "grow_target",
           "relocate_dead", "sample_targets")

# (activation, inverse) pairs mapping raw parameters <-> linear values
ActPair = Tuple[Callable, Callable]

_IDENTITY: ActPair = (lambda x: x, lambda x: x)


class MCMCConfig(NamedTuple):
    cap_max: int = 1_000_000        # gsplat MCMCStrategy default
    min_opacity: float = 0.005
    noise_lr: float = 5e5
    refine_every: int = 100
    refine_start: int = 500
    refine_stop: int = 25_000
    grow_factor: float = 1.05       # gsplat add_new_gs: +5% per refine


def grow_target(n_alive: int, capacity: int, mcfg: MCMCConfig) -> int:
    """gsplat add_new_gs target: min(cap, floor(grow_factor * n_alive)),
    never below n_alive. The product is taken in float32, as the JAX
    package takes it: float64 gives other counts."""
    cap = min(capacity, mcfg.cap_max)
    tgt = int(np.floor(np.float32(n_alive) * np.float32(mcfg.grow_factor)))
    return max(min(tgt, cap), n_alive)


def sample_targets(opacities: torch.Tensor, live: torch.Tensor, n: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """n draws (with replacement) of live indices, probability proportional
    to opacity. With no live slot every draw is 0, as JAX's categorical
    over all -inf logits gives."""
    weights = torch.where(live, opacities, torch.zeros_like(opacities))
    if not bool(live.any()):
        return torch.zeros((n,), dtype=torch.long, device=opacities.device)
    draw = lambda: torch.multinomial(weights, n, replacement=True,
                                     generator=generator)
    if not weights.is_cuda:
        return draw()
    # on the card under deterministic algorithms (the module docstring says
    # why), the caller's setting restored after
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return draw()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def relocate_dead(params: Dict[str, torch.Tensor],
                  opacity_act: Optional[ActPair] = None,
                  scale_act: Optional[ActPair] = None, *,
                  min_opacity: float = 0.005,
                  n_alive: Optional[int] = None,
                  n_target: Optional[int] = None,
                  targets: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Relocate dead (and newly grown) Gaussians onto samples of live ones.

    params: means (N,3), scales (N,3), quats (N,4), opacities (N,), sh0,
    shN, raw; ``opacity_act``/``scale_act`` map raw to linear values
    (identity under compat_raw_activations) and back. Only slots < n_alive
    are live; with n_target > n_alive, slots [n_alive, n_target) are grown.
    ``targets`` (N,): a live target for every slot (used where dead);
    drawn by `sample_targets` with ``generator`` when not given.

    Returns (new params, relocated mask (N,) bool: the Adam slots to
    reset)."""
    op_fn, op_inv = opacity_act if opacity_act is not None else _IDENTITY
    sc_fn, sc_inv = scale_act if scale_act is not None else _IDENTITY
    op_raw = params["opacities"]
    # raw (compat) opacities are unconstrained: clamp to [0, 1) so the
    # binomial correction (1-op)^(1/ratio) cannot see a negative base
    op = torch.clamp(op_fn(op_raw), 1e-6, 1.0 - 1e-6)
    sc = sc_fn(params["scales"])
    n = op.shape[0]
    idx = torch.arange(n, device=op.device)
    if n_alive is None:
        prefix = torch.ones((n,), dtype=torch.bool, device=op.device)
        grown = torch.zeros_like(prefix)
    else:
        prefix = idx < n_alive
        upper = n_alive if n_target is None else n_target
        grown = (idx >= n_alive) & (idx < upper)
    dead = (prefix & (op <= min_opacity)) | grown
    live = prefix & ~dead
    if targets is None:
        targets = sample_targets(op, live, n, generator)
    targets = targets.to(device=op.device, dtype=torch.long)

    # clone count per target: 1 (itself) + the dead slots pointing at it
    counts = torch.zeros((n,), dtype=torch.long, device=op.device)
    counts.index_add_(0, targets, dead.long())
    ratio = 1.0 + counts.float()                         # (N,) per target

    op_t = op[targets]
    ratio_t = ratio[targets]
    new_op_dead = 1.0 - (1.0 - op_t) ** (1.0 / ratio_t)
    new_scales_dead = sc[targets] / torch.sqrt(ratio_t)[:, None]
    # sources sampled at least once get the corrected values too
    src_touched = counts > 0
    new_op_src = 1.0 - (1.0 - op) ** (1.0 / ratio)
    new_scales_src = sc / torch.sqrt(ratio)[:, None]

    out = dict(params)
    for key in ("means", "quats", "sh0", "shN"):
        v = params[key]
        d = dead.reshape((n,) + (1,) * (v.dim() - 1))
        out[key] = torch.where(d, v[targets], v)

    scales = torch.where(src_touched[:, None], new_scales_src, sc)
    scales = torch.where(dead[:, None], new_scales_dead, scales)
    touched = src_touched | dead
    out["scales"] = torch.where(touched[:, None],
                                sc_inv(torch.clamp(scales, min=1e-12)),
                                params["scales"])
    op_new = torch.where(src_touched, new_op_src, op)
    op_new = torch.where(dead, new_op_dead, op_new)
    # gsplat relocate() floors at min_opacity, or relocated slots die again
    # at the next refine
    out["opacities"] = torch.where(
        touched, op_inv(torch.clamp(op_new, min_opacity, 1.0 - 1e-6)),
        op_raw)
    return out, touched


def add_position_noise(params: Dict[str, torch.Tensor], lr: float,
                       noise_lr: float = 5e5,
                       opacity_act: Optional[ActPair] = None,
                       scale_act: Optional[ActPair] = None,
                       n_alive: Optional[int] = None,
                       eps: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
    """Covariance-shaped position noise (the every-step MCMC exploration):
    Sigma eps * gate(opacity) * noise_lr * lr, with Sigma = R diag(s^2) R^T
    the full 3D covariance and gate = sigmoid(-100 (op - 0.995 * 0.005)).
    ``eps`` (N, 3) standard normal, drawn with ``generator`` when not
    given. Only alive slots move when ``n_alive`` is given."""
    op_fn, _ = opacity_act if opacity_act is not None else _IDENTITY
    sc_fn, _ = scale_act if scale_act is not None else _IDENTITY
    means = params["means"]
    op = op_fn(params["opacities"])
    sc = sc_fn(params["scales"])
    if eps is None:
        eps = torch.randn(means.shape, generator=generator,
                          device=means.device, dtype=means.dtype)
    R = quat_to_rotmat_wxyz(params["quats"])
    # Sigma eps = R diag(s^2) R^T eps, right to left
    shaped = torch.einsum("nij,nj->ni", R,
                          sc * sc * torch.einsum("nji,nj->ni", R, eps))
    gate = torch.sigmoid(-100.0 * (op - 0.995 * 0.005))
    step = shaped * (gate * noise_lr * lr)[:, None]
    if n_alive is not None:
        alive = torch.arange(op.shape[0], device=op.device) < n_alive
        step = torch.where(alive[:, None], step, torch.zeros_like(step))
    out = dict(params)
    out["means"] = means + step
    return out
