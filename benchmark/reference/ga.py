"""Plain PyTorch reference of the sparse global alignment that follows the
network in reconstruction (MASt3R's `sparse_global_alignment`, as the
program's `reconstruct_scene` configures it): intrinsics, MST-chained
poses, per-camera scale and core depth, optimised by Adam in two phases, a
3D-3D correspondence loss then a 2D reprojection loss, each with a
low-weight regression fallback on the pairs whose matching is not trusted.

It runs on the condensed correspondences and the spanning tree the
program built for the same scene (`data`, `mst`), from the same start
(the condensed core depth, identity relative poses, the base focals), in
``dtype`` throughout. `objective` is the fine phase's loss of an answer
(K, cam2w, core depth): how well that answer explains the
correspondences. Imports nothing of the program under test.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def quat_to_rotmat(q):
    q = q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def robust(dist, gamma: float, alpha, eps: float = 1e-3):
    """(d + eps)^g - eps^g with g annealed from 1 (alpha 1) to gamma."""
    g = alpha * 1.0 + (1.0 - alpha) * gamma
    return (dist + eps) ** g - eps ** g


class Data:
    """The condensed scene as tensors of one dtype on one device."""

    def __init__(self, data, mst, device, dtype):
        t = lambda x: torch.as_tensor(np.asarray(x), device=device,
                                      dtype=dtype)
        i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
        m = len(data.corr_idx1)
        self.imsizes, self.base_focals = t(data.imsizes), t(data.base_focals)
        self.median_depths = t(data.median_depths)
        self.core_pix = t(data.core_pix)
        self.img1, self.idx1 = i(data.corr_img1), i(data.corr_idx1)
        self.img2, self.idx2 = i(data.corr_img2), i(data.corr_idx2)
        self.conf = t(data.corr_conf)
        self.pair = i(data.corr_pair)
        cp = np.asarray(data.core_pix)
        self.pix1 = t(cp[data.corr_idx1] if data.corr_pix1 is None
                      else data.corr_pix1)
        self.pix2 = t(cp[data.corr_idx2] if data.corr_pix2 is None
                      else data.corr_pix2)
        self.doff1 = t(np.ones(m) if data.corr_doff1 is None
                       else data.corr_doff1)
        self.doff2 = t(np.ones(m) if data.corr_doff2 is None
                       else data.corr_doff2)
        self.pair_img1, self.pair_img2 = i(data.pair_img1), i(data.pair_img2)
        self.pair_ok = torch.as_tensor(np.asarray(data.pair_matching_ok,
                                                  bool), device=device)
        self.p21_pts, self.p21_conf = t(data.preds21_pts), t(
            data.preds21_conf)
        self.core_depth0, self.pps0 = t(data.core_depth), t(data.pps)
        self.root, self.edges = int(mst[0]), [(int(a), int(b))
                                               for a, b in mst[1]]
        diag = torch.linalg.norm(self.imsizes, dim=1)
        self.min_f, self.max_f = 0.25 * diag, 10.0 * diag


def answer(p: Dict[str, torch.Tensor], d: Data):
    """(K, cam2w, core depth) of the parameters ``p``: focals clamped to
    [0.25, 10] image diagonals, relative poses chained along the MST from
    its root, each camera centred on its median-depth focal plane, the
    global scale pinned by the smallest camera size, depth added to each
    camera's focal-plane distance."""
    c = p["pps"].shape[0]
    f = torch.minimum(torch.maximum(torch.exp(p["log_f"]), d.min_f),
                      d.max_f)
    pp = p["pps"] * d.imsizes
    K = torch.zeros((c, 3, 3), dtype=f.dtype, device=f.device)
    K[:, 0, 0], K[:, 1, 1] = f, f
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = pp[:, 0], pp[:, 1], 1.0
    sizes = torch.exp(p["log_sizes"])
    scale = 1.0 / torch.min(sizes)
    z_cam = sizes * d.median_depths * f / d.base_focals
    rel = torch.zeros((c, 4, 4), dtype=f.dtype, device=f.device)
    rel[:, :3, :3] = quat_to_rotmat(p["quats"])
    rel[:, :3, 3] = p["trans"]
    rel[:, 3, 3] = 1.0
    chain = [None] * c
    chain[d.root] = rel[d.root]
    for a, b in d.edges:
        chain[b] = chain[a] @ rel[b]
    chain = torch.stack(chain)
    offset = z_cam[:, None] * torch.cat(
        [d.imsizes / f[:, None] * (0.5 - p["pps"]),
         torch.ones((c, 1), dtype=f.dtype, device=f.device)], -1)
    trans = scale * (chain[:, :3, 3]
                     - (chain[:, :3, :3] @ offset[:, :, None])[..., 0])
    cam2w = chain.clone()
    cam2w[:, :3, 3] = trans
    depth = scale * (z_cam[:, None] + (p["core"] - 1.0)
                     * (d.median_depths * sizes)[:, None])
    return K, cam2w, depth


def _endpoints(K, cam2w, depth, cam, idx, pix, doff):
    z = depth[cam, idx] * doff
    k = K[cam]
    x = (pix[:, 0] - k[:, 0, 2]) / k[:, 0, 0] * z
    y = (pix[:, 1] - k[:, 1, 2]) / k[:, 1, 1] * z
    pts = torch.stack([x, y, z], -1)
    T = cam2w[cam]
    return (T[:, :3, :3] @ pts[:, :, None])[..., 0] + T[:, :3, 3]


def _dist(v):
    return torch.sqrt(torch.sum(v * v, -1))


def loss_3d(K, cam2w, depth, d: Data, gamma, alpha):
    w = d.conf * d.pair_ok[d.pair]
    p1 = _endpoints(K, cam2w, depth, d.img1, d.idx1, d.pix1, d.doff1)
    p2 = _endpoints(K, cam2w, depth, d.img2, d.idx2, d.pix2, d.doff2)
    loss = torch.sum(w * robust(_dist(p1 - p2 + 1e-12), gamma, alpha))
    return loss / torch.clamp(torch.sum(w), min=1e-8)


def loss_2d(K, cam2w, depth, d: Data, gamma, alpha):
    w = d.conf * d.pair_ok[d.pair]
    R, t = cam2w[:, :3, :3], cam2w[:, :3, 3]
    w2c_r = R.transpose(1, 2)
    w2c_t = -(w2c_r @ t[:, :, None])[..., 0]
    p2 = _endpoints(K, cam2w, depth, d.img2, d.idx2, d.pix2, d.doff2)
    cam = (w2c_r[d.img1] @ p2[:, :, None])[..., 0] + w2c_t[d.img1]
    homo = (K[d.img1] @ cam[:, :, None])[..., 0]
    z = homo[:, 2:3]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    uv = homo[:, :2] / z
    loss = torch.sum(w * robust(_dist(uv - d.pix1 + 1e-12), gamma, alpha))
    return loss / torch.clamp(torch.sum(w), min=1e-8)


def loss_fallback(K, cam2w, depth, d: Data, gamma):
    """Pointmap regression on the pairs whose matching is not trusted."""
    pix = d.core_pix[None]
    x = (pix[..., 0] - K[:, 0, 2, None]) / K[:, 0, 0, None] * depth
    y = (pix[..., 1] - K[:, 1, 2, None]) / K[:, 1, 1, None] * depth
    cam_pts = torch.stack([x, y, depth], -1)                  # (C, S, 3)
    world = (torch.einsum("cij,csj->csi", cam2w[:, :3, :3], cam_pts)
             + cam2w[:, None, :3, 3])
    T = cam2w[d.pair_img2]
    tgt = torch.einsum("pij,psj->psi", T[:, :3, :3], d.p21_pts) \
        + T[:, None, :3, 3]
    w = d.p21_conf * (~d.pair_ok)[:, None]
    loss = torch.sum(w * robust(_dist(world[d.pair_img1] - tgt + 1e-12),
                                gamma, 0.0))
    cf = torch.sum(w)
    return torch.where(cf > 0, loss / torch.clamp(cf, min=1e-8),
                       torch.zeros_like(loss))


def objective(K, cam2w, depth, d: Data, cfg: dict, alpha: float):
    """The fine phase's loss at annealing ``alpha`` (its last step's is
    1 - (niter2 - 1) / niter2)."""
    return (loss_2d(K, cam2w, depth, d, cfg["gamma2"], alpha)
            + cfg["loss_dust3r_w"] * loss_fallback(K, cam2w, depth, d,
                                                   cfg["gamma_d"]))


def _phase(p, d: Data, cfg: dict, phase: int):
    niter = cfg["niter1"] if phase == 1 else cfg["niter2"]
    lr0 = cfg["lr1"] if phase == 1 else cfg["lr2"]
    gamma = cfg["gamma1"] if phase == 1 else cfg["gamma2"]
    b1, b2, eps = cfg["adam_b1"], cfg["adam_b2"], 1e-8
    train = (["quats", "trans", "log_sizes"] if phase == 1 else
             ["pps", "log_f", "quats", "trans", "log_sizes"]
             + (["core"] if cfg["opt_depth"] else []))
    if not cfg["opt_pp"] and phase == 2:
        train.remove("pps")
    leaves = {k: v.detach().clone().requires_grad_(k in train)
              for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
    nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
    stopped, last = False, float("inf")
    for it in range(niter):
        frac = it / max(niter, 1)
        K, cam2w, depth = answer(leaves, d)
        main = (loss_3d if phase == 1 else loss_2d)(K, cam2w, depth, d,
                                                    gamma, 1.0 - frac)
        loss = main + cfg["loss_dust3r_w"] * loss_fallback(
            K, cam2w, depth, d, cfg["gamma_d"])
        if not torch.isfinite(loss):
            stopped = True
        if stopped:
            continue
        last = float(loss)
        grads = torch.autograd.grad(loss, [leaves[k] for k in train])
        lr = cfg["lr_end"] + (lr0 - cfg["lr_end"]) * (
            1 + math.cos(math.pi * frac)) / 2
        bc1, bc2 = 1 - b1 ** (it + 1), 1 - b2 ** (it + 1)
        with torch.no_grad():
            for k, g in zip(train, grads):
                mu[k] = (1 - b1) * g + b1 * mu[k]
                nu[k] = (1 - b2) * g * g + b2 * nu[k]
                leaves[k] -= lr * (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                                   + eps)
            q = leaves["quats"]
            q.copy_(q * torch.rsqrt(torch.sum(q * q, -1, keepdim=True)
                                    + 1e-12))
    return {k: v.detach() for k, v in leaves.items()}, last


def start(d: Data) -> Dict[str, torch.Tensor]:
    """The parameters both phases start from: the condensed principal
    points, base focals and core depth, identity relative poses, unit
    sizes."""
    c = d.pps0.shape[0]
    dt, dev = d.pps0.dtype, d.pps0.device
    quats = torch.zeros((c, 4), dtype=dt, device=dev)
    quats[:, 0] = 1.0
    return {"pps": d.pps0, "log_f": torch.log(d.base_focals), "quats": quats,
            "trans": torch.zeros((c, 3), dtype=dt, device=dev),
            "log_sizes": torch.zeros(c, dtype=dt, device=dev),
            "core": d.core_depth0}


def align(d: Data, cfg: dict):
    """Both phases from `start`; returns (K, cam2w, depth, the last step's
    loss, as the optimiser computed it)."""
    p, last = start(d), float("nan")
    if cfg["niter1"]:
        p, last = _phase(p, d, cfg, 1)
    if cfg["niter2"]:
        p, last = _phase(p, d, cfg, 2)
    with torch.no_grad():
        return (*answer(p, d), last)


def dense_points(K, cam2w, core_depth, anchor_idx, anchor_offset, conf,
                 h: int, w: int, clean: bool = True):
    """Each camera's dense world points (C, H*W, 3), depths (C, H*W) and
    confidences: each pixel at its anchor cell's core depth times its
    offset; with ``clean`` a point that lies 5% in front of what another
    camera sees there gets confidence 1."""
    dense = torch.gather(core_depth, 1, anchor_idx) * anchor_offset
    c = dense.shape[0]
    dev, dt = dense.device, dense.dtype
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=dt),
                            torch.arange(w, device=dev, dtype=dt),
                            indexing="ij")
    px, py = xs.reshape(1, -1), ys.reshape(1, -1)
    x = (px - K[:, 0, 2, None]) / K[:, 0, 0, None] * dense
    y = (py - K[:, 1, 2, None]) / K[:, 1, 1, None] * dense
    cam = torch.stack([x, y, dense], -1)
    world = cam @ cam2w[:, :3, :3].transpose(1, 2) + cam2w[:, None, :3, 3]
    if not clean or c == 1:
        return world, dense, conf
    conf = conf.clone()
    Rt = cam2w[:, :3, :3].transpose(1, 2)
    tt = -(Rt @ cam2w[:, :3, 3:])[..., 0]
    for i in range(c):
        bad = torch.zeros(h * w, dtype=torch.bool, device=dev)
        for j in range(c):
            if i == j:
                continue
            p = world[i] @ Rt[j].T + tt[j]
            z = p[:, 2]
            zc = torch.clamp(z, min=1e-6)
            u = K[j, 0, 0] * p[:, 0] / zc + K[j, 0, 2]
            v = K[j, 1, 1] * p[:, 1] / zc + K[j, 1, 2]
            ui = torch.clamp(torch.round(u).long(), 0, w - 1)
            vi = torch.clamp(torch.round(v).long(), 0, h - 1)
            inside = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (z > 1e-6)
            seen = dense[j].reshape(h, w)[vi, ui]
            bad |= inside & (z < seen * 0.95)
        conf[i] = torch.where(bad, torch.ones_like(conf[i]), conf[i])
    return world, dense, conf
