"""Plain PyTorch reference of a 3DGS training step as the program's
`run_optim` defines it (starster/gs.py's loop over gsplat): every camera
rendered by `reference.raster`, loss per camera 0.8 L1 + 0.2 (1 - SSIM)
(torchmetrics' SSIM: 11-tap Gaussian window, sigma 1.5, VALID), plus the
opacity and scale regularisers (means of sigmoid(opacity) and exp(scale),
times 0.01 and the camera count), Adam (0.9, 0.999, 1e-8; optax's order,
the bias corrections in float32), then the MCMC position noise drawn from
the state's own generator. Raw opacities and scales go to the rasterizer
(the reference's compatibility mode). The tile budgets are the smallest
powers of two the scene needs, under the configured ceilings. `refine` is
gsplat MCMC's refine step (relocation of the dead, growth by 5% to the
cap) with its draws from a given generator state.

Imports nothing of the program under test."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .raster import render_one, rotmat, project, tile_lists

B1, B2, EPS = 0.9, 0.999, 1e-8
# gsplat MCMCStrategy's defaults: a Gaussian at or under MIN_OPACITY is
# dead; each refine grows the live count by GROW, up to the cap
MIN_OPACITY, GROW = 0.005, 1.05


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x, y (H, W, 3) in [0, 1] -> mean SSIM."""
    g = np.exp(-((np.arange(11, dtype=np.float32) - 5.0) ** 2) / (2 * 1.5
                                                                 ** 2))
    g = torch.as_tensor(g / g.sum(), device=x.device)
    a = x.permute(2, 0, 1)[None]
    b = y.permute(2, 0, 1)[None]

    def blur(t):
        t = F.conv2d(t, g.reshape(1, 1, 11, 1).expand(3, 1, 11, 1), groups=3)
        return F.conv2d(t, g.reshape(1, 1, 1, 11).expand(3, 1, 1, 11),
                        groups=3)

    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu_a, mu_b = blur(a), blur(b)
    s_a = blur(a * a) - mu_a * mu_a
    s_b = blur(b * b) - mu_b * mu_b
    s_ab = blur(a * b) - mu_a * mu_b
    m = ((2 * mu_a * mu_b + c1) * (2 * s_ab + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (s_a + s_b + c2))
    return m.mean()


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def budgets(g, w2c, Ks, w, h, cfg) -> Tuple[int, int]:
    """(tiles per Gaussian, slots per tile): the smallest powers of two
    the scene needs now (slots: 1.25 times the fullest tile, at least
    128), under the configured ceilings."""
    with torch.no_grad():
        projs = [project(g["means"], g["quats"], g["scales"],
                         g["opacities"], g["sh"], w2c[c], Ks[c])
                 for c in range(w2c.shape[0])]
        area = max(tile_lists(p, w, h, cfg["tile_size"], 1, 1)[2]["area"]
                   for p in projs)
        mt = min(_pow2(max(area, 2)), cfg["max_tiles_per_gaussian"])
        mc = max(tile_lists(p, w, h, cfg["tile_size"], mt, 1)[2]["max_count"]
                 for p in projs)
        mpt = min(max(_pow2(int(mc * 1.25) + 1), 128), cfg["max_per_tile"])
    return mt, mpt


def start(pts, cols, sh_bands: int, init_scale: float, device
          ) -> Dict[str, torch.Tensor]:
    """The Gaussians' start, one a point: raw scales ``init_scale``,
    identity rotations, raw opacity 1, every SH band 1 - colour (the
    reference loop's compatibility mode)."""
    n = pts.shape[0]
    sh = 1.0 - torch.as_tensor(cols, device=device)
    q = torch.zeros((n, 4), device=device)
    q[:, 0] = 1.0
    return {"means": torch.as_tensor(pts, device=device),
            "scales": torch.full((n, 3), init_scale, device=device),
            "quats": q, "opacities": torch.ones(n, device=device),
            "sh0": sh[:, None, :].clone(),
            "shN": sh[:, None, :].repeat(1, sh_bands, 1)}


def inputs(p: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {"means": p["means"], "quats": p["quats"], "scales": p["scales"],
            "opacities": p["opacities"], "sh": p["shN"]}


def loss_and_grads(params: Dict[str, torch.Tensor], gt, w2c, Ks, cfg,
                   lists) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The step's loss and its gradient, one camera's backward at a time
    (the loss is a sum over cameras)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    c, h, w = gt.shape[:3]
    mt, mpt = lists
    total = 0.0
    for cam in range(c):
        rgb, _, _ = render_one(inputs(leaves), w2c[cam], Ks[cam], w, h,
                               cfg["tile_size"], mt, mpt)
        l1 = torch.mean(torch.abs(gt[cam] - rgb))
        loss = 0.8 * l1 + 0.2 * (1.0 - ssim(gt[cam], rgb))
        loss.backward()
        total += float(loss.detach())
    n = leaves["opacities"].shape[0]
    reg = c * (0.01 * torch.sum(torch.abs(torch.sigmoid(
        leaves["opacities"]))) / n + 0.01 * torch.sum(torch.abs(torch.exp(
            leaves["scales"]))) / (3.0 * n))
    reg.backward()
    total += float(reg.detach())
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return total, grads


def adam(params, grads, mu, nu, count: int, lr: float):
    n = count + 1
    bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(n))
    bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(n))
    out, mu2, nu2 = {}, {}, {}
    for k, g in grads.items():
        mu2[k] = (1 - B1) * g + B1 * mu[k]
        nu2[k] = (1 - B2) * g * g + B2 * nu[k]
        out[k] = params[k] - lr * (mu2[k] / bc1) / (torch.sqrt(nu2[k] / bc2)
                                                    + EPS)
    return out, mu2, nu2


def position_noise(params, lr: float, noise_lr: float, gen,
                   n_alive: int = None):
    """gsplat MCMC's every-step exploration: Sigma eps, gated by a low
    opacity, times noise_lr and the means' learning rate (the first
    ``n_alive`` rows only, where given)."""
    means = params["means"]
    eps = torch.randn(means.shape, generator=gen, device=means.device,
                      dtype=means.dtype)
    R = rotmat(params["quats"])
    s = params["scales"]
    shaped = (R @ ((s * s) * (R.transpose(1, 2) @ eps[:, :, None])[..., 0])
              [:, :, None])[..., 0]
    gate = torch.sigmoid(-100.0 * (params["opacities"] - 0.995 * 0.005))
    if n_alive is not None:
        gate = torch.where(torch.arange(gate.shape[0], device=gate.device)
                           < n_alive, gate, torch.zeros_like(gate))
    out = dict(params)
    out["means"] = means + shaped * (gate * noise_lr * lr)[:, None]
    return out


def refine(params, mu, nu, n_alive: int, cap_max: int, lr: float,
           noise_lr: float, gen):
    """One refine step after Adam, then that step's position noise, from
    ``gen`` as it stood before the refine: (params, mu, nu, n_alive,
    the count relocated). Dead slots (opacity at or under MIN_OPACITY)
    and the grown ones take a live slot drawn with probability
    proportional to opacity (one draw a slot, drawn in a fixed order);
    each drawn slot and its k copies share its opacity as
    1 - (1 - o)^(1/(k+1)), floored at MIN_OPACITY, and divide its scales
    by sqrt(k+1); their Adam moments restart from zero."""
    n = params["opacities"].shape[0]
    dev = params["opacities"].device
    grown_to = max(min(int(np.floor(np.float32(n_alive) * np.float32(GROW))),
                       min(n, cap_max)), n_alive)
    row = torch.arange(n, device=dev)
    op = torch.clamp(params["opacities"], 1e-6, 1.0 - 1e-6)
    dead = ((row < n_alive) & (op <= MIN_OPACITY)) | \
        ((row >= n_alive) & (row < grown_to))
    live = (row < n_alive) & ~dead
    if bool(live.any()):
        was = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            src = torch.multinomial(torch.where(live, op, 0.0), n,
                                    replacement=True, generator=gen)
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
    else:
        src = torch.zeros(n, dtype=torch.long, device=dev)
    copies = torch.bincount(src[dead], minlength=n)
    share = (1.0 + copies.float())        # a drawn slot's copies and itself
    drawn = copies > 0
    touched = drawn | dead
    k = torch.where(dead, share[src], share)
    base_op = torch.where(dead, op[src], op)
    base_sc = torch.where(dead[:, None], params["scales"][src],
                          params["scales"])
    new_op = torch.clamp(1.0 - (1.0 - base_op) ** (1.0 / k), MIN_OPACITY,
                         1.0 - 1e-6)
    new_sc = torch.clamp(base_sc / torch.sqrt(k)[:, None], min=1e-12)
    out = {}
    for key, v in params.items():
        m = dead.reshape((n,) + (1,) * (v.dim() - 1))
        out[key] = torch.where(m, v[src], v)
    out["opacities"] = torch.where(touched, new_op, params["opacities"])
    out["scales"] = torch.where(touched[:, None], new_sc, params["scales"])
    zero = lambda x: torch.where(
        touched.reshape((n,) + (1,) * (x.dim() - 1)), torch.zeros_like(x), x)
    out = position_noise(out, lr, noise_lr, gen, grown_to)
    return (out, {k: zero(v) for k, v in mu.items()},
            {k: zero(v) for k, v in nu.items()}, grown_to,
            int(dead.sum()))


def train(params, gt, w2c, Ks, cfg, steps: int, seed: int
          ) -> List[Tuple[float, Dict, Dict]]:
    """``steps`` steps from ``params`` (no refine among them); returns,
    after each, (loss, gradient, parameters, the step's tile budgets)."""
    gen = torch.Generator(device=gt.device).manual_seed(seed)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out = []
    for i in range(steps):
        lists = budgets(inputs(params), w2c, Ks, gt.shape[2], gt.shape[1],
                        cfg)
        loss, grads = loss_and_grads(params, gt, w2c, Ks, cfg, lists)
        with torch.no_grad():
            params, mu, nu = adam(params, grads, mu, nu, i, cfg["lr"])
            params = position_noise(params, cfg["lr"], cfg["noise_lr"], gen)
        out.append((loss, grads, params, lists))
    return out
