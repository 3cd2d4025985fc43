"""The GA's step on the card around the fused loss: the
reparameterisation before it and, after it, its backward with the masked
Adam, as two hand-written CUDA kernels (`csrc/ga_step.cu`).

One step of `ga._Phase` on the card is `ga_step_cuda`:
  1. `ga_reparam` reads the six parameter leaves, the step count and the
     phase's statics, and writes what `ga.make_K_cam_depth` returns (K,
     w2c, cam2w, the core depth), proj = K @ w2c[:, :3], the annealing
     alpha = 1 - count / niter, and what the backward reads again: each
     camera's relative pose, its pose along the MST chain and its core
     values before the depth mode;
  2. the fused loss (`ga_loss.ga_loss_cuda`, two kernels) computes the loss
     and its gradient with respect to (K, cam2w, proj, depth);
  3. `ga_update` back-propagates that gradient through the
     reparameterisation to the six leaves and runs, in place, the masked
     Adam step that `ga._Phase.update` writes in PyTorch for the CPU's
     step: the cosine LR and the bias corrections from the count, the
     per-leaf masks, the moments and the update in optax's order, the
     quaternions renormalised, the NaN freeze (from the first non-finite
     loss on, the params, moments and loss stay), then the last loss, the
     stop flag and the count.
No autograd runs on the card's step. What the kernels read that does not
change within a phase (each camera's image size, base focal, median depth,
focal limits and freeze flag, the lora basis, the MST's edges in
topological order) is built once, when the phase is built
(`make_step_data`). The kernels adapt to what the phase holds: C, S, the
phase, the frozen cameras, shared intrinsics, exp depth, the depth mode
and the lora basis.

`ga_step_in_order` is the two kernels' arithmetic and summation order in
PyTorch around `ga_loss.ga_loss_in_order`: the tests' picture of the
kernels, as `ga_loss_in_order` is of the fused loss. The GA on the CPU
takes its step through autograd of the losses' chain (the plain version).
Every sum is taken in a fixed order (each thread its terms in turn, a
shuffle tree over each warp, the warps in order; the chain's backward in
one thread, the edges in reverse), with no atomics, so a step gives the
same bits every time, on the card as in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..kernels import build, launch
from .ga_loss import (LossData, _grad_layout, _size, _views, ga_loss_cuda,
                      ga_loss_in_order)

__all__ = ("StepData", "build_kernels", "ga_step_cuda", "ga_step_in_order",
           "make_step_data", "reparam_in_order", "update_in_order")

# the kernels' constants (csrc/ga_step.cu): threads of a `ga_reparam` block
# (core points a depth block); threads of a `ga_update` block, its blocks
# (one thread-block cluster), their threads and warps, which share the sums
# over the core points; the per-camera statics (W, H, base focal, median
# depth, focal limits, 1 where free); the update's per-camera work slots
_THREADS = 256
_UPDATE_THREADS, _UPDATE_RANKS = 512, 8
_SUM_THREADS = _UPDATE_THREADS * _UPDATE_RANKS
_SUM_WARPS = _SUM_THREADS // 32
_STATICS = 8
_WORK = 112
# quat_normalize's eps and Adam's
_QEPS = 1e-12
_ADAM_EPS = 1e-8
# flags
_SHARED, _EXP_DEPTH, _MUL, _OPT_PP, _OPT_DEPTH = 1, 2, 4, 8, 16
# the order of the leaves (`ga.GAParams`)
_LEAVES = ("pps", "log_focals", "quats", "trans", "log_sizes", "core_depth")


def _f32(x: float) -> float:
    return float(np.float32(x))


class StepData(NamedTuple):
    """One phase's static inputs of the two kernels (`make_step_data`)."""

    phase: int
    dims: Tuple[int, int, int]   # C, S, k (the lora basis's terms, or 0)
    niter: int
    flags: int
    # float32 values: lr_end, lr_base - lr_end, b1, 1 - b1, b2, 1 - b2,
    # Adam's eps, pi
    hyper: Tuple[float, ...]
    fstat: torch.Tensor   # (C, _STATICS) per-camera statics, then the basis
    istat: torch.Tensor   # int32: root, edges, then each edge's parent, child
    edges: Tuple[Tuple[int, int], ...]   # host copy of the edges
    root: int

    def statics(self) -> Dict[str, torch.Tensor]:
        c = self.dims[0]
        st = self.fstat[:c * _STATICS].view(c, _STATICS)
        return {n: st[:, i] for i, n in enumerate(
            ("W", "H", "bf", "md", "fmin", "fmax", "free"))}

    def basis(self) -> torch.Tensor:
        c, s, k = self.dims
        return self.fstat[c * _STATICS:].view(c, s, k)


def make_step_data(state, phase: int, niter: int, lr_base: float,
                   lr_end: float, cfg) -> StepData:
    """The static inputs of one phase's step on ``state`` (a `ga.GAState`),
    on the state's device. No read to the host."""
    c, s = state.imsizes.shape[0], state.core_pix.shape[0]
    basis = state.depth_basis
    k = 0 if basis is None else int(basis.shape[-1])
    if cfg.depth_mode not in ("add", "mul"):
        raise ValueError(cfg.depth_mode)
    free = (~state.freeze).to(torch.float32)
    st = torch.stack([state.imsizes[:, 0], state.imsizes[:, 1],
                      state.base_focals, state.median_depths,
                      state.min_focals, state.max_focals, free,
                      torch.zeros_like(free)], 1)
    fstat = st.reshape(-1) if basis is None else torch.cat(
        [st.reshape(-1), basis.reshape(-1)])
    edges = tuple(zip(state.edge_parent, state.edge_child))
    if len(edges) != c - 1:
        raise ValueError(f"the MST must have C - 1 = {c - 1} edges, got "
                         f"{len(edges)}")
    ints = [state.root, len(edges)] + [p for p, _ in edges] + [
        ch for _, ch in edges]
    flags = ((_SHARED if cfg.shared_intrinsics else 0)
             | (_EXP_DEPTH if cfg.exp_depth else 0)
             | (_MUL if cfg.depth_mode == "mul" else 0)
             | (_OPT_PP if cfg.opt_pp else 0)
             | (_OPT_DEPTH if cfg.opt_depth else 0))
    b1, b2 = cfg.adam_b1, cfg.adam_b2
    hyper = tuple(_f32(v) for v in (lr_end, lr_base - lr_end, b1, 1.0 - b1,
                                    b2, 1.0 - b2, _ADAM_EPS, math.pi))
    return StepData(phase, (c, s, k), int(niter), flags, hyper,
                    fstat.to(torch.float32).contiguous(),
                    torch.tensor(ints, dtype=torch.int32,
                                 device=fstat.device),
                    edges, int(state.root))


def _fwd_layout(c, s, k):
    """The step's device buffer: the reparameterisation's outputs (what the
    fused loss reads and the tests compare), what the backward reads again,
    and the update's scratch."""
    return (("K", (c, 9)), ("cam2w", (c, 16)), ("w2c", (c, 16)),
            ("proj", (c, 12)), ("depth", (c, s)), ("alpha", (1,)),
            ("pad", (3,)), ("rel", (c, 12)), ("chain", (c, 12)),
            ("core", (c, s)), ("gcore", (c, s) if k else (0,)),
            ("work", (c, _WORK)), ("wpart", (c, _SUM_WARPS * 3)),
            ("gcc", (c, k)),
            ("lpart", (c * max(_SUM_THREADS, k) if k else 0,)))


def step_buffer(data: StepData) -> torch.Tensor:
    """A zeroed buffer for one phase's step, laid out as `_fwd_layout`."""
    return torch.zeros(_size(_fwd_layout(*data.dims)), dtype=torch.float32,
                       device=data.fstat.device)


def fwd_views(buf: torch.Tensor, data: StepData) -> Dict[str, torch.Tensor]:
    return _views(buf, _fwd_layout(*data.dims))


def loss_inputs(buf: torch.Tensor, data: StepData):
    """The fused loss's inputs as views of the step's buffer: K (C, 3, 3),
    cam2w (C, 4, 4), depth (C, S), proj (C, 3, 4) in phase 2 or None, and
    alpha ()."""
    c, s, _ = data.dims
    v = fwd_views(buf, data)
    return (v["K"].view(c, 3, 3), v["cam2w"].view(c, 4, 4), v["depth"],
            v["proj"].view(c, 3, 4) if data.phase == 2 else None,
            v["alpha"].view(()))


# ---------------------------------------------------------------------------
# The launches


def build_kernels() -> None:
    """Build the step's two sources (the fused loss's and this one's) where
    they are not built yet, in one parallel batch, so the second costs the
    GA's first call no more set-up than the first."""
    build(("ga_loss", "ga_step"))


def _check_state(tensors: Sequence[torch.Tensor], data: StepData):
    c, s, k = data.dims
    shapes = [(c, 2), (c,), (c, 4), (c, 3), (c,), (c, k or s)] * 3
    for i, (t, shape) in enumerate(zip(tensors[:18], shapes)):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != data.fstat.device):
            raise ValueError(
                f"{_LEAVES[i % 6]} ({('param', 'mu', 'nu')[i // 6]}) must be "
                f"contiguous float32 {shape} on {data.fstat.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    count, stopped, last_loss = tensors[18:]
    for t, dtype in ((count, torch.int64), (stopped, torch.bool),
                     (last_loss, torch.float32)):
        if t.dtype != dtype or t.shape != () or \
                t.device != data.fstat.device:
            raise ValueError(f"the step's {dtype} scalar must be () on "
                             f"{data.fstat.device}")


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def ga_reparam_cuda(params, count: torch.Tensor, buf: torch.Tensor,
                    data: StepData) -> None:
    """Launch `ga_reparam`: the step's buffer gets the reparameterisation
    of ``params`` and alpha from ``count``."""
    c, s, k = data.dims
    if buf.numel() != _size(_fwd_layout(c, s, k)) or not buf.is_cuda:
        raise ValueError("the step buffer must be `step_buffer(data)`")
    ptrs = _ptrs(list(params))
    dev = buf.device
    with torch.cuda.device(dev):
        launch("ga_reparam", ctypes.cast(ptrs, ctypes.c_void_p),
               count.data_ptr(), data.fstat.data_ptr(),
               data.istat.data_ptr(), buf.data_ptr(), c, s, k, data.flags,
               data.niter, torch.cuda.current_stream(dev).cuda_stream)


def ga_update_cuda(tensors: Sequence[torch.Tensor], loss: torch.Tensor,
                   grads: torch.Tensor, buf: torch.Tensor,
                   data: StepData) -> None:
    """Launch `ga_update` on the step's state ``tensors`` (params, mu, nu
    leaves, count, stopped, last_loss), in place, from the fused loss's
    ``loss`` and flat ``grads``."""
    c, s, k = data.dims
    if grads.numel() != _size(_grad_layout(c, s, data.phase)) or \
            loss.shape != () or not grads.is_cuda:
        raise ValueError("grads and loss must be the fused loss's outputs")
    ptrs = _ptrs(tensors)
    f32 = ctypes.c_float
    dev = buf.device
    with torch.cuda.device(dev):
        launch("ga_update", ctypes.cast(ptrs, ctypes.c_void_p),
               loss.data_ptr(), grads.data_ptr(), data.fstat.data_ptr(),
               data.istat.data_ptr(), buf.data_ptr(), c, s, k, data.flags,
               data.phase, data.niter, *[f32(v) for v in data.hyper],
               torch.cuda.current_stream(dev).cuda_stream)


def ga_step_cuda(tensors: Sequence[torch.Tensor], buf: torch.Tensor,
                 data: StepData, loss_data: LossData) -> None:
    """One GA step on the card, in place on the step's state ``tensors``
    (the six params, mu and nu leaves, count, stopped, last_loss):
    `ga_reparam`, the fused loss, `ga_update`. Checks device, types and
    shapes; reads nothing to the host."""
    if not buf.is_cuda:
        raise ValueError("ga_step_cuda needs CUDA tensors")
    if loss_data.phase != data.phase or loss_data.dims[:2] != data.dims[:2]:
        raise ValueError("the loss data is of another phase or shape")
    _check_state(tensors, data)
    ga_reparam_cuda(tensors[:6], tensors[18], buf, data)
    loss, grads = ga_loss_cuda(*loss_inputs(buf, data), loss_data)
    ga_update_cuda(tensors, loss, grads, buf, data)
    ga_step_cuda.launches += 1


# steps that Python sees (`ga_reparam`, the fused loss's two kernels and
# `ga_update` each): under a CUDA graph, the warm-up steps and the capture,
# not the replays
ga_step_cuda.launches = 0


# ---------------------------------------------------------------------------
# The kernels' arithmetic and order in PyTorch. Scalars of a camera are
# (C,) tensors, a matrix a list of them, so each line is one rounding of
# the kernel's per-camera code.


def _tmax(a, b):
    """The larger, NaN where either is (torch.maximum's value)."""
    return torch.where((a > b) | torch.isnan(a), a, b)


def _tmin(a, b):
    return torch.where((a < b) | torch.isnan(a), a, b)


def _seq_sum(terms: List[torch.Tensor]) -> torch.Tensor:
    """((t0 + t1) + t2) + ..."""
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _cameras(params, data: StepData) -> Dict:
    """`camera_forward` of every camera: the per-camera values of the
    reparameterisation (before the MST chain)."""
    c = data.dims[0]
    st = data.statics()
    pps, lf, q, t, ls, _ = params
    if data.flags & _SHARED:
        lfc = (_seq_sum([lf[i] for i in range(c)]) / c).expand(c)
        ppc = [(_seq_sum([pps[i, j] for i in range(c)]) / c).expand(c)
               for j in range(2)]
    else:
        lfc, ppc = lf, [pps[:, 0], pps[:, 1]]
    v = {"ppc": ppc}
    v["e"] = torch.exp(lfc)
    v["m1"] = _tmax(v["e"], st["fmin"])
    f = v["f"] = _tmin(v["m1"], st["fmax"])
    v["ppx"], v["ppy"] = ppc[0] * st["W"], ppc[1] * st["H"]
    sz = v["sz"] = torch.exp(ls)
    mn = sz[0]
    for i in range(1, c):
        mn = _tmin(mn, sz[i])
    v["mn"] = mn
    v["gs"] = 1.0 / mn
    v["zq"] = sz * st["md"]
    v["z"] = (v["zq"] * f) / st["bf"]
    v["ms"] = st["md"] * sz
    v["WF"] = [st["W"] / f, st["H"] / f]
    v["h"] = [0.5 - ppc[0], 0.5 - ppc[1]]
    v["A"] = [v["WF"][0] * v["h"][0], v["WF"][1] * v["h"][1]]
    v["to"] = [v["z"] * v["A"][0], v["z"] * v["A"][1], v["z"]]
    qs = [q[:, i] for i in range(4)]
    v["q0"] = qs
    n1 = torch.rsqrt(_seq_sum([x * x for x in qs]) + _QEPS)
    q1 = [x * n1 for x in qs]
    n2 = torch.rsqrt(_seq_sum([x * x for x in q1]) + _QEPS)
    q2 = [x * n2 for x in q1]
    v.update(n1=n1, q1=q1, n2=n2, q2=q2)
    w, x, y, z = q2
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    v["R"] = [[1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy)],
              [2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx)],
              [2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)]]
    v["t"] = [t[:, i] for i in range(3)]
    return v


def _rows(m: torch.Tensor) -> List[List[torch.Tensor]]:
    """A (3, 4) matrix as rows of 0-dim tensors."""
    return [[m[i, j] for j in range(4)] for i in range(3)]


def _compose(A, B):
    """`compose`: A @ B of two poses (3 x 4, last row 0 0 0 1)."""
    out = [[((A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j])
             for j in range(4)] for i in range(3)]
    for i in range(3):
        out[i][3] = out[i][3] + A[i][3]
    return out


def _chain(rel: torch.Tensor, data: StepData) -> torch.Tensor:
    """The poses along the MST: (C, 12) from the relative poses (C, 12),
    each edge's product in topological order (one thread's walk)."""
    c = data.dims[0]
    chain = [None] * c
    chain[data.root] = _rows(rel[data.root].view(3, 4))
    for p, ch in data.edges:
        chain[ch] = _compose(chain[p], _rows(rel[ch].view(3, 4)))
    return torch.stack([torch.stack([torch.stack(r) for r in m]).reshape(-1)
                        for m in chain])


def _core(params, data: StepData) -> torch.Tensor:
    """The core values (C, S) before the depth mode: the core depth, its
    exp, or the lora expansion of the (exp of the) coefficients, its k
    terms summed in turn."""
    cd = params[5]
    if data.flags & _EXP_DEPTH:
        cd = torch.exp(cd)
    if not data.dims[2]:
        return cd
    basis = data.basis()
    return _seq_sum([basis[:, :, i] * cd[:, i:i + 1]
                     for i in range(data.dims[2])])


def _depth0(core, v, data: StepData):
    if data.flags & _MUL:
        return v["z"][:, None] * core
    return v["z"][:, None] + (core - 1.0) * v["ms"][:, None]


def reparam_in_order(params, count: torch.Tensor, data: StepData
                     ) -> Dict[str, torch.Tensor]:
    """`ga_reparam`'s outputs: K (C, 9), cam2w, w2c (C, 16), proj (C, 12),
    depth (C, S), alpha (1,), rel, chain (C, 12), core (C, S)."""
    c = data.dims[0]
    v = _cameras(params, data)
    R, t, f = v["R"], v["t"], v["f"]
    rel = torch.stack([R[0][0], R[0][1], R[0][2], t[0], R[1][0], R[1][1],
                       R[1][2], t[1], R[2][0], R[2][1], R[2][2], t[2]], 1)
    chain = _chain(rel, data)
    Rc = [[chain[:, 4 * i + j] for j in range(3)] for i in range(3)]
    tc = [chain[:, 4 * i + 3] for i in range(3)]
    to, gs = v["to"], v["gs"]
    u = [(Rc[a][0] * to[0] + Rc[a][1] * to[1]) + Rc[a][2] * to[2]
         for a in range(3)]
    nt = [gs * (tc[a] - u[a]) for a in range(3)]
    ti = [-((Rc[0][i] * nt[0] + Rc[1][i] * nt[1]) + Rc[2][i] * nt[2])
          for i in range(3)]
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    K = torch.stack([f, zero, v["ppx"], zero, f, v["ppy"], zero, zero, one],
                    1)
    cam2w = torch.stack([Rc[0][0], Rc[0][1], Rc[0][2], nt[0],
                         Rc[1][0], Rc[1][1], Rc[1][2], nt[1],
                         Rc[2][0], Rc[2][1], Rc[2][2], nt[2],
                         zero, zero, zero, one], 1)
    W = [[Rc[0][i], Rc[1][i], Rc[2][i], ti[i]] for i in range(3)]
    w2c = torch.stack(W[0] + W[1] + W[2] + [zero, zero, zero, one], 1)
    proj = torch.stack([f * W[0][j] + v["ppx"] * W[2][j] for j in range(4)]
                       + [f * W[1][j] + v["ppy"] * W[2][j]
                          for j in range(4)]
                       + [W[2][j] for j in range(4)], 1)
    core = _core(params, data)
    depth = gs * _depth0(core, v, data)
    frac = count.to(torch.float32) / max(data.niter, 1)
    return {"K": K, "cam2w": cam2w, "w2c": w2c, "proj": proj,
            "depth": depth, "alpha": (1.0 - frac).reshape(1), "rel": rel,
            "chain": chain, "core": core}


def _tree32(x: torch.Tensor) -> torch.Tensor:
    """A warp's shuffle tree over the last axis of 32 lanes: lane 0's sum."""
    x = x.clone()
    off = 16
    while off:
        x[..., :off] = x[..., :off] + x[..., off:2 * off]
        off //= 2
    return x[..., 0]


def _cluster_sums(v: torch.Tensor) -> torch.Tensor:
    """Stage A's sums of (R, n) rows over the update's cluster of T
    threads: thread i adds entries i, i + T, ... in turn from 0, each
    warp's tree, the warps in order. (R,)."""
    r, n = v.shape
    width = -(-max(n, 1) // _SUM_THREADS) * _SUM_THREADS
    v = torch.cat([v, v.new_zeros((r, width - n))], 1).view(
        r, -1, _SUM_THREADS)
    acc = v.new_zeros((r, _SUM_THREADS))
    for i in range(v.shape[1]):
        acc = acc + v[:, i]
    warps = _tree32(acc.view(r, _SUM_WARPS, 32))
    return _seq_sum([warps[:, i] for i in range(_SUM_WARPS)])


def _lora_grad(gcore: torch.Tensor, data: StepData) -> torch.Tensor:
    """Stage B: (C, k) sums over s of basis[c, s, i] * gcore[c, s]: G =
    max(T // k, 1) groups of the cluster's threads, group g adding s = g,
    g + G, ... in turn from 0, then the groups in order."""
    c, s, k = data.dims
    g = max(_SUM_THREADS // k, 1)
    n = -(-s // g) * g
    prod = data.basis() * gcore[:, :, None]
    prod = torch.cat([prod, prod.new_zeros((c, n - s, k))], 1).view(
        c, n // g, g, k)
    acc = prod.new_zeros((c, g, k))
    for i in range(n // g):
        acc = acc + prod[:, i]
    return _seq_sum([acc[:, j] for j in range(g)])


def _adam(x, mu, nu, g, mask, lr, bc1, bc2, data: StepData):
    """Adam's step on one leaf, masked, in optax's order: (x, mu, nu)."""
    _, _, b1, omb1, b2, omb2, eps, _ = data.hyper
    g = g * mask
    mu1 = omb1 * g + b1 * mu
    nu1 = omb2 * (g * g) + b2 * nu
    return x + (-lr) * ((mu1 / bc1) / (torch.sqrt(nu1 / bc2) + eps)), mu1, nu1


def _quat_bwd(gR, v):
    """The rotation's gradient (3 x 3 of (C,)) to the quaternion leaf's,
    through quat_to_rotmat and both normalisations."""
    w, x, y, z = v["q2"]
    d = [[2.0 * gR[i][j] for j in range(3)] for i in range(3)]
    gxx = -(d[1][1] + d[2][2])
    gyy = -(d[0][0] + d[2][2])
    gzz = -(d[0][0] + d[1][1])
    gxy, gwz = d[0][1] + d[1][0], d[1][0] - d[0][1]
    gxz, gwy = d[0][2] + d[2][0], d[0][2] - d[2][0]
    gyz, gwx = d[1][2] + d[2][1], d[2][1] - d[1][2]
    g = [(gwx * x + gwy * y) + gwz * z,
         (((gxx * x) * 2.0 + gwx * w) + gxy * y) + gxz * z,
         (((gyy * y) * 2.0 + gwy * w) + gxy * x) + gyz * z,
         (((gzz * z) * 2.0 + gwz * w) + gxz * x) + gyz * y]
    for qin, n in ((v["q1"], v["n2"]), (v["q0"], v["n1"])):
        dot = _seq_sum([g[i] * qin[i] for i in range(4)])
        gS = dot * (((n * n) * n) * -0.5)
        g = [g[i] * n + (qin[i] * gS) * 2.0 for i in range(4)]
    return g


def update_in_order(tensors: Sequence[torch.Tensor], loss: torch.Tensor,
                    grads: torch.Tensor, fwd: Dict[str, torch.Tensor],
                    data: StepData) -> List[torch.Tensor]:
    """`ga_update` on the step's state ``tensors`` (the six params, mu and
    nu leaves, count, stopped, last_loss) from the fused loss's ``loss``
    and flat ``grads`` and the reparameterisation's ``fwd``
    (`reparam_in_order`'s): the new state, as new tensors."""
    c, s, k = data.dims
    params, mu, nu = tensors[:6], tensors[6:12], tensors[12:18]
    count, stopped, last_loss = tensors[18:]
    phase, flags = data.phase, data.flags
    st = data.statics()
    free = st["free"]
    lr_end, dlr, b1, _, b2, _, _, pi = data.hyper
    frac = count.to(torch.float32) / max(data.niter, 1)
    lr = lr_end + (dlr * (1.0 + torch.cos(pi * frac))) / 2.0
    n = (count + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(n, b1), n)
    bc2 = 1.0 - torch.pow(torch.full_like(n, b2), n)
    stop = stopped | ~torch.isfinite(loss)
    gv = _views(grads, _grad_layout(c, s, phase))
    gK, gC, gD = gv["K"].reshape(c, 9), gv["cam2w"].reshape(c, 16), gv[
        "depth"]
    gP = gv["proj"].reshape(c, 12) if phase == 2 else None
    v = _cameras(params, data)
    gs, z, ms, f = v["gs"], v["z"], v["ms"], v["f"]

    # stage A: the depth's terms, summed over S for each camera
    core = fwd["core"]
    d0 = _depth0(core, v, data)
    gd0 = gD * gs
    mul = bool(flags & _MUL)
    a_gs = _cluster_sums(gD * d0)
    a_z = _cluster_sums(gd0 * core if mul else gd0)
    a_ms = None if mul else _cluster_sums(gd0 * (core - 1.0))
    gcore = gd0 * (z if mul else ms)[:, None]
    zero = torch.zeros_like(f)
    opt_depth = zero + (free * float(bool(flags & _OPT_DEPTH))
                        if phase == 2 else 0.0)

    # stage C: each camera's backward up to the chain
    R, to = v["R"], v["to"]
    chain = fwd["chain"]
    Rc = [[chain[:, 4 * i + j] for j in range(3)] for i in range(3)]
    tc = [chain[:, 4 * i + 3] for i in range(3)]
    u = [(Rc[a][0] * to[0] + Rc[a][1] * to[1]) + Rc[a][2] * to[2]
         for a in range(3)]
    dd = [tc[a] - u[a] for a in range(3)]
    nt = [gs * dd[a] for a in range(3)]
    gK00, gK02, gK11, gK12 = gK[:, 0], gK[:, 2], gK[:, 4], gK[:, 5]
    gRc = [[gC[:, 4 * a + b] for b in range(3)] for a in range(3)]
    gnt = [gC[:, 4 * a + 3] for a in range(3)]
    if phase == 2:
        w2c = fwd["w2c"]
        Wm = [[w2c[:, 4 * i + j] for j in range(4)] for i in range(3)]
        P = [[gP[:, 4 * i + j] for j in range(4)] for i in range(3)]
        gK00 = gK00 + _seq_sum([P[0][j] * Wm[0][j] for j in range(4)])
        gK02 = gK02 + _seq_sum([P[0][j] * Wm[2][j] for j in range(4)])
        gK11 = gK11 + _seq_sum([P[1][j] * Wm[1][j] for j in range(4)])
        gK12 = gK12 + _seq_sum([P[1][j] * Wm[2][j] for j in range(4)])
        gW = [[f * P[0][j] for j in range(4)], [f * P[1][j] for j in range(4)],
              [(v["ppx"] * P[0][j] + v["ppy"] * P[1][j]) + P[2][j]
               for j in range(4)]]
        gvv = [-gW[i][3] for i in range(3)]
        gRc = [[gRc[a][b] + (gW[b][a] + gvv[b] * nt[a]) for b in range(3)]
               for a in range(3)]
        gnt = [gnt[a] + ((Rc[a][0] * gvv[0] + Rc[a][1] * gvv[1])
                         + Rc[a][2] * gvv[2]) for a in range(3)]
    ggs = ((gnt[0] * dd[0] + gnt[1] * dd[1]) + gnt[2] * dd[2]) + a_gs
    gdd = [gnt[a] * gs for a in range(3)]
    gu = [-gdd[a] for a in range(3)]
    gRc = [[gRc[a][b] + gu[a] * to[b] for b in range(3)] for a in range(3)]
    gto = [(Rc[0][b] * gu[0] + Rc[1][b] * gu[1]) + Rc[2][b] * gu[2]
           for b in range(3)]
    gz = ((gto[0] * v["A"][0] + gto[1] * v["A"][1]) + gto[2]) + a_z
    gA = [gto[0] * z, gto[1] * z]
    gWF = [gA[i] * v["h"][i] for i in range(2)]
    gh = [gA[i] * v["WF"][i] for i in range(2)]
    gzq = gz / st["bf"]
    gf = gK00 + gK11
    gf = gf + (-(gWF[0] * (v["WF"][0] / f)))
    gf = gf + (-(gWF[1] * (v["WF"][1] / f)))
    gf = gf + gzq * v["zq"]
    gsz = (gzq * f) * st["md"]
    if not mul:
        gsz = gsz + a_ms * st["md"]
    gm1 = torch.where(v["m1"] > st["fmax"], zero,
                      torch.where(v["m1"] == st["fmax"], gf / 2.0, gf))
    ge = torch.where(v["e"] < st["fmin"], zero,
                     torch.where(v["e"] == st["fmin"], gm1 / 2.0, gm1))
    glf = ge * v["e"]
    gpp = [gK02 * st["W"] + (-gh[0]), gK12 * st["H"] + (-gh[1])]

    # stage D: the chain's backward (one thread, the edges in reverse), the
    # global scale's and the shared intrinsics' sums
    gchain = [[[gRc[a][b][i] for b in range(3)] + [gdd[a][i]]
               for a in range(3)] for i in range(c)]
    rel = fwd["rel"]
    grel = [None] * c
    for p, ch in reversed(data.edges):
        A, B, gO = _rows(chain[p].view(3, 4)), _rows(rel[ch].view(3, 4)), \
            gchain[ch]
        grel[ch] = [[(A[0][kk] * gO[0][j] + A[1][kk] * gO[1][j])
                     + A[2][kk] * gO[2][j] for j in range(4)]
                    for kk in range(3)]
        for i in range(3):
            for kk in range(3):
                gchain[p][i][kk] = gchain[p][i][kk] + (
                    ((gO[i][0] * B[kk][0] + gO[i][1] * B[kk][1])
                     + gO[i][2] * B[kk][2]) + gO[i][3] * B[kk][3])
            gchain[p][i][3] = gchain[p][i][3] + gO[i][3]
    grel[data.root] = gchain[data.root]
    ggs_all = _seq_sum([ggs[i] for i in range(c)])
    gmn = -ggs_all * (gs * gs)
    tied = v["sz"] == v["mn"]
    gsz = gsz + torch.where(tied, gmn / tied.sum().to(torch.float32), zero)
    if flags & _SHARED:
        glf = (_seq_sum([glf[i] for i in range(c)]) / c).expand(c)
        gpp = [(_seq_sum([gpp[j][i] for i in range(c)]) / c).expand(c)
               for j in range(2)]

    # stage E: each camera's leaves, Adam, the freeze
    grel_t = [[torch.stack([grel[i][a][b] for i in range(c)])
               for b in range(4)] for a in range(3)]
    gq = _quat_bwd([[grel_t[a][b] for b in range(3)] for a in range(3)], v)
    gls = gsz * v["sz"]
    if phase == 1:
        m_pp = m_lf = zero
    else:
        m_pp, m_lf = free * float(bool(flags & _OPT_PP)), free
    leaf_grads = [torch.stack(gpp, 1), glf, torch.stack(gq, 1),
                  torch.stack([grel_t[a][3] for a in range(3)], 1), gls]
    masks = [m_pp[:, None], m_lf, free[:, None], free[:, None], free]
    if k:
        gcc = _lora_grad(gcore, data)
        if flags & _EXP_DEPTH:
            gcc = gcc * torch.exp(params[5])
        leaf_grads.append(gcc)
    else:
        leaf_grads.append(gcore * core if flags & _EXP_DEPTH else gcore)
    masks.append(opt_depth[:, None])
    new = [_adam(x, m, nv, g, mk, lr, bc1, bc2, data)
           for x, m, nv, g, mk in zip(params, mu, nu, leaf_grads, masks)]
    q = [new[2][0][:, i] for i in range(4)]
    nq = torch.rsqrt(_seq_sum([x * x for x in q]) + _QEPS)
    new[2] = (torch.stack([x * nq for x in q], 1),) + new[2][1:]
    keep = lambda old, upd: torch.where(stop, old, upd)
    return ([keep(x, nw[0]) for x, nw in zip(params, new)]
            + [keep(x, nw[1]) for x, nw in zip(mu, new)]
            + [keep(x, nw[2]) for x, nw in zip(nu, new)]
            + [count + 1, stop, keep(last_loss, loss)])


def ga_step_in_order(tensors: Sequence[torch.Tensor], data: StepData,
                     loss_data: LossData):
    """One step in the kernels' order in PyTorch: (the new state as
    `update_in_order` returns it, the reparameterisation's outputs, the
    fused loss's loss and flat gradient)."""
    fwd = reparam_in_order(tensors[:6], tensors[18], data)
    c, s, _ = data.dims
    loss, grads = ga_loss_in_order(
        fwd["K"].view(c, 3, 3), fwd["cam2w"].view(c, 4, 4), fwd["depth"],
        fwd["proj"].view(c, 3, 4) if data.phase == 2 else None,
        fwd["alpha"].view(()), loss_data)
    return update_in_order(tensors, loss, grads, fwd, data), fwd, loss, grads
