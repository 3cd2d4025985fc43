"""The GA's correspondence losses and their gradient as one pass on the
card (`csrc/ga_loss.cu`), the middle launch of the captured GA step
(`alignment/ga_step.py::ga_step_cuda`).

One phase's loss is ``main + loss_dust3r_w * reg``: ``main`` the
correspondence loss (`ga._loss_3d` in phase 1, `ga._loss_2d` in phase 2)
and ``reg`` the dust3r fallback (`ga._loss_dust3r` on `ga._core_pts3d`).
`ga_loss_cuda` takes the reparameterisation's outputs, K (C, 3, 3), cam2w
(C, 4, 4), the core depth (C, S) and, in phase 2, proj = K @ w2c[:, :3]
(C, 3, 4), with the annealing alpha as a device scalar, and computes the
loss and its gradient with respect to those inputs in one pass (counted in
``.launches``). `ga_loss_in_order` is the kernel's arithmetic in the
kernel's order in PyTorch: the tests' picture of the kernel. The GA on the
CPU takes the autograd chain of `alignment/ga.py` (the plain version).

What the kernel reads that does not change within a phase is built once,
when the phase is built (`make_loss_data`): the weights (``corr_conf * ok
* ~frozen`` for the phase, ``preds21_conf * pair_w``) and their clamped
sums, computed as the plain chain computes them; the correspondences'
static data in each side's order, the stable order of its depth rows
(``img * S + idx`` over the C * S rows of the core depth, by
`ops/row_sum.py::_gather_csr`), so each camera's correspondences, and each
depth row's, are consecutive; each camera's first item and first block in
that order; the pairs by their first and by their second camera, in the
same form.

The launch shape (`LossPlan`) comes from (M, S, C) alone: ``ipt``
correspondences a thread, so that each side has about two blocks a
streaming multiprocessor or more, ``nb`` blocks a side (enough for every
camera's run), ``nj`` blocks of core points a camera in the fallback. The
summation order depends on nothing else, so a call gives the same bits
every time, on the card as in a CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels import launch
from ..ops.row_sum import _gather_csr

__all__ = ("LossData", "LossPlan", "ga_loss_cuda", "ga_loss_in_order",
           "make_loss_data")

# the kernel's constants (csrc/ga_loss.cu): threads a block (and core points
# a fallback block), warps a block, the slots of a camera partial (fx, cx,
# fy, cy, cam2w rows 0-2, the loss), of a pair partial (cam2w rows 0-2),
# the static scalars; the blocks a side aims at (two a streaming
# multiprocessor of the H100's 132), and the most correspondences a thread
_THREADS, _WARPS, _SLOTS, _LOSS, _PAIR_SLOTS, _SCALARS = 256, 8, 17, 16, 12, 8
_BLOCKS_PER_SIDE, _MAX_IPT = 264, 8
_EPS, _OFFSET, _ZMIN = 1e-3, 1e-12, 1e-8
# K's entries the losses read (fx, cx, fy, cy), in slot order
_K_ENTRIES = (0, 2, 4, 5)


class LossPlan(NamedTuple):
    """The kernel's launch shape: ``ipt`` correspondences a thread (a
    block's chunk is 256 * ipt), ``nb`` blocks a side (ceil(M / chunk) + C,
    enough for every camera's run of chunks), ``nj`` blocks of 256 core
    points a camera in the fallback."""

    ipt: int
    nb: int
    nj: int

    @property
    def chunk(self) -> int:
        return _THREADS * self.ipt


def loss_plan(m: int, s: int, c: int) -> LossPlan:
    """The launch shape for M correspondences, S core points and C cameras,
    from the shapes alone."""
    ipt = 1
    while ipt < _MAX_IPT and m >= 2 * ipt * _THREADS * _BLOCKS_PER_SIDE:
        ipt *= 2
    return LossPlan(ipt, -(-m // (_THREADS * ipt)) + c, -(-s // _THREADS))


def _int_layout(c, s, m, p):
    return (("ids1", (m, 4)), ("ids2", (m, 4)), ("off1", (c * s + 1,)),
            ("off2", (c * s + 1,)), ("coff1", (c + 1,)),
            ("bstart1", (c + 1,)), ("coff2", (c + 1,)),
            ("bstart2", (c + 1,)), ("porder1", (p,)), ("poff1", (c + 1,)),
            ("porder2", (p,)), ("poff2", (c + 1,)), ("pimg2", (p,)))


def _float_layout(c, s, m, p):
    return (("vals1", (m, 8)), ("vals2", (m, 8)), ("core_pix", (s, 2)),
            ("preds", (p, s, 3)), ("fw", (p, s)), ("scal", (_SCALARS,)))


def _scratch_layout(c, s, m, p, plan):
    return (("part1", (plan.nb, _SLOTS)), ("part2", (plan.nb, _SLOTS)),
            ("fbc", (c, plan.nj, _SLOTS)),
            ("fbp", (plan.nj, p, _PAIR_SLOTS)), ("fbd", (c * s,)),
            ("ct1", (m,)), ("ct2", (m,)))


def _grad_layout(c, s, phase):
    return (("K", (c, 3, 3)), ("cam2w", (c, 4, 4)),
            ("proj", (c, 3, 4) if phase == 2 else (0,)), ("depth", (c, s)))


def _numel(shape) -> int:
    n = 1
    for v in shape:
        n *= v
    return n


def _views(flat: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    out, at = {}, 0
    for name, shape in layout:
        n = _numel(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out


def _size(layout) -> int:
    return sum(_numel(shape) for _, shape in layout)


class LossData(NamedTuple):
    """One phase's static inputs of the fused loss (`make_loss_data`)."""

    phase: int
    gamma: float       # the phase's robust gamma
    gamma_d: float     # the fallback's
    weight_d: float    # loss_dust3r_w
    dims: Tuple[int, int, int, int]   # C, S, M, P
    plan: LossPlan
    istat: torch.Tensor   # int32, `_int_layout`
    fstat: torch.Tensor   # float32, `_float_layout`

    def ints(self) -> Dict[str, torch.Tensor]:
        return _views(self.istat, _int_layout(*self.dims))

    def floats(self) -> Dict[str, torch.Tensor]:
        return _views(self.fstat, _float_layout(*self.dims))


def make_loss_data(state, phase: int, gamma: float, gamma_d: float,
                   weight_d: float) -> LossData:
    """The static inputs of one phase's fused loss on ``state`` (a
    `ga.GAState`), on the state's device: the weights and their clamped
    sums as the plain chain computes them, the correspondences in each
    side's depth-row order, the block schedule and the pairs' orders, each
    order `_gather_csr` of the state's own index."""
    c, s = state.imsizes.shape[0], state.core_pix.shape[0]
    m, p = state.corr_idx1.numel(), state.pair_img1.numel()
    plan = loss_plan(m, s, c)
    dev = state.corr_conf.device
    ok = state.pair_matching_ok[state.corr_pair]
    if phase == 1:
        frozen = state.freeze[state.corr_img1] & state.freeze[state.corr_img2]
    else:
        frozen = state.freeze[state.corr_img1]
    w = state.corr_conf * ok * (~frozen)
    wsum = torch.clamp(torch.sum(w), min=1e-8)
    pair_w = (~state.pair_matching_ok) & (~(state.freeze[state.pair_img1]
                                            & state.freeze[state.pair_img2]))
    fw = state.preds21_conf * pair_w[:, None]
    cf = torch.sum(fw)
    cfc = torch.clamp(cf, min=1e-8)
    one = torch.ones((), dtype=torch.float32, device=dev)
    scal = torch.stack([wsum, one / wsum, cf, cfc, (one * weight_d) / cfc]
                       + [torch.zeros_like(one)] * (_SCALARS - 5))

    depth1 = state.corr_img1 * s + state.corr_idx1
    depth2 = state.corr_img2 * s + state.corr_idx2
    ids = torch.stack([state.corr_img1, state.corr_img2, depth1, depth2],
                      1).to(torch.int32)
    vals = torch.stack([state.corr_pix1[:, 0], state.corr_pix1[:, 1],
                        state.corr_pix2[:, 0], state.corr_pix2[:, 1],
                        state.corr_doff1, state.corr_doff2, w,
                        torch.zeros_like(w)], 1)
    ints, floats = {}, {}
    rows = torch.arange(c + 1, device=dev) * s
    for e, depth_rows in ((1, depth1), (2, depth2)):
        order, off = _gather_csr(depth_rows, c * s)
        order = order.long()
        ints[f"ids{e}"], floats[f"vals{e}"] = ids[order], vals[order]
        coff = off[rows]
        nblk = (coff[1:] - coff[:-1] + plan.chunk - 1) // plan.chunk
        bstart = torch.zeros_like(coff)
        bstart[1:] = torch.cumsum(nblk, 0)
        ints.update({f"off{e}": off, f"coff{e}": coff, f"bstart{e}": bstart})
    (ints["porder1"], ints["poff1"]), (ints["porder2"], ints["poff2"]) = (
        _gather_csr(state.pair_img1, c), _gather_csr(state.pair_img2, c))
    ints["pimg2"] = state.pair_img2
    floats.update(core_pix=state.core_pix, preds=state.preds21_pts, fw=fw,
                  scal=scal)
    cat = lambda layout, parts, dtype: torch.cat([
        parts[name].reshape(-1).to(dtype) for name, _ in layout])
    return LossData(phase, float(gamma), float(gamma_d), float(weight_d),
                    (c, s, m, p), plan,
                    cat(_int_layout(c, s, m, p), ints, torch.int32),
                    cat(_float_layout(c, s, m, p), floats, torch.float32))


def _check_inputs(K, cam2w, depth, proj, alpha, data: LossData):
    c, s, _, _ = data.dims
    want = {"K": (K, (c, 3, 3)), "cam2w": (cam2w, (c, 4, 4)),
            "depth": (depth, (c, s)), "alpha": (alpha, ())}
    if data.phase == 2:
        want["proj"] = (proj, (c, 3, 4))
    elif proj is not None:
        raise ValueError("phase 1 takes no proj")
    for name, (t, shape) in want.items():
        if t is None or t.dtype != torch.float32 or tuple(t.shape) != shape \
                or t.device != data.istat.device:
            raise ValueError(
                f"{name} must be float32 {shape} on {data.istat.device}, got "
                + ("None" if t is None else
                   f"{t.dtype} {tuple(t.shape)} on {t.device}"))


def _gammas(data: LossData):
    """The fallback's exponent (alpha 0: g = gamma_d), its exponent less 1
    (the pow backward's) and eps ** exponent, in Python floats as the plain
    chain takes them."""
    gd = data.gamma_d
    return gd, gd - 1, _EPS ** gd


def ga_loss_cuda(K: torch.Tensor, cam2w: torch.Tensor, depth: torch.Tensor,
                 proj: Optional[torch.Tensor], alpha: torch.Tensor,
                 data: LossData) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused loss on the card: (loss (), the gradient with
    respect to K, cam2w, proj (phase 2) and depth, flat, laid out as
    `_grad_layout`). Checks device, types and shapes."""
    if not K.is_cuda:
        raise ValueError("ga_loss_cuda needs CUDA tensors")
    _check_inputs(K, cam2w, depth, proj, alpha, data)
    c, s, m, p = data.dims
    plan = data.plan
    K, cam2w, depth = K.contiguous(), cam2w.contiguous(), depth.contiguous()
    if proj is not None:
        proj = proj.contiguous()
    dev = K.device
    scratch = torch.empty(_size(_scratch_layout(c, s, m, p, plan)),
                          dtype=torch.float32, device=dev)
    grads = torch.empty(_size(_grad_layout(c, s, data.phase)),
                        dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    gd, gd_m1, eps_gd = _gammas(data)
    f32 = ctypes.c_float
    with torch.cuda.device(dev):
        launch("ga_loss", K.data_ptr(), cam2w.data_ptr(), depth.data_ptr(),
               None if proj is None else proj.data_ptr(), alpha.data_ptr(),
               data.istat.data_ptr(), data.fstat.data_ptr(),
               scratch.data_ptr(), grads.data_ptr(), loss.data_ptr(),
               data.phase, c, s, m, p, plan.ipt, plan.nb, plan.nj,
               f32(data.gamma), f32(gd), f32(gd_m1), f32(eps_gd),
               f32(data.weight_d),
               torch.cuda.current_stream(dev).cuda_stream)
    ga_loss_cuda.launches += 1
    return loss, grads


# calls of the fused loss (two kernel launches each) that Python sees: under
# a CUDA graph, the warm-up steps and the capture, not the replays
ga_loss_cuda.launches = 0


# ---------------------------------------------------------------------------
# The kernel's arithmetic and order in PyTorch


def _tree32(x: torch.Tensor) -> torch.Tensor:
    """A warp's shuffle tree over the last-but-one axis of 32 lanes (lane l
    adds lane l + off for off = 16, 8, 4, 2, 1): lane 0's sum."""
    x = x.clone()
    off = 16
    while off:
        x[..., :off, :] = x[..., :off, :] + x[..., off:2 * off, :]
        off //= 2
    return x[..., 0, :]


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """`block_sum` over (..., 256 threads, N): each warp's tree, then the
    warps added in order."""
    w = _tree32(v.reshape(v.shape[:-2] + (_WARPS, 32, v.shape[-1])))
    out = w[..., 0, :]
    for i in range(1, _WARPS):
        out = out + w[..., i, :]
    return out


def _warp_sum(v: torch.Tensor) -> torch.Tensor:
    """`warp_sum` of each row of (R, n): lane l adds entries l, l + 32, ...
    in turn from 0, then the tree. (R,)."""
    r, n = v.shape
    if n == 0:
        return v.new_zeros((r,))
    pad = -(-n // 32) * 32
    v = torch.cat([v, v.new_zeros((r, pad - n))], 1).view(r, -1, 32)
    s = v.new_zeros((r, 32))
    for i in range(v.shape[1]):
        s = s + v[:, i]
    return _tree32(s[:, :, None])[:, 0]


def _seg_sum(vals: torch.Tensor, start: torch.Tensor,
             count: torch.Tensor) -> torch.Tensor:
    """Sums of runs vals[start[r]:start[r] + count[r]] in turn from 0."""
    out = vals.new_zeros(start.shape)
    if vals.numel() == 0:
        return out
    last = vals.numel() - 1
    for i in range(int(count.max()) if count.numel() else 0):
        k = torch.clamp(start + i, max=last)
        out = out + torch.where(i < count, vals[k], torch.zeros_like(out))
    return out


def _unproject(cam: dict, px, py, z):
    a = (px - cam["cx"]) / cam["fx"]
    b = (py - cam["cy"]) / cam["fy"]
    q = (a * z, b * z, z)
    T = cam["T"]
    p = [((T[:, 4 * i] * q[0] + T[:, 4 * i + 1] * q[1]) + T[:, 4 * i + 2]
          * q[2]) + T[:, 4 * i + 3] for i in range(3)]
    return a, b, q, p


def _unproject_bwd(cam: dict, ray, gp):
    """(16 camera slot contributions, the gradient of z)."""
    a, b, q, _ = ray
    T = cam["T"]
    slots = [None] * 16
    for i in range(3):
        for j in range(3):
            slots[4 + 4 * i + j] = gp[i] * q[j]
        slots[4 + 4 * i + 3] = gp[i]
    gq = [(T[:, j] * gp[0] + T[:, 4 + j] * gp[1]) + T[:, 8 + j] * gp[2]
          for j in range(3)]
    z = q[2]
    ga, gb = gq[0] * z, gq[1] * z
    slots[0] = -(ga * a) / cam["fx"]
    slots[1] = -(ga / cam["fx"])
    slots[2] = -(gb * b) / cam["fy"]
    slots[3] = -(gb / cam["fy"])
    return slots, (gq[2] + gq[0] * a) + gq[1] * b


def _cams(K, cam2w, idx):
    k = K.reshape(-1, 9)[idx]
    return {"fx": k[:, 0], "cx": k[:, 2], "fy": k[:, 4], "cy": k[:, 5],
            "T": cam2w.reshape(-1, 16)[idx, :12]}


def _corr_items(phase, side, ids, vals, K, cam2w, depth, proj, g, g_m1,
                eps_g, coef_main):
    """`corr_item` over a side's correspondences: ((M, 17) contributions,
    (M,) depth cotangent)."""
    ids = ids.long()
    dflat = depth.reshape(-1)
    zero = torch.zeros_like(vals[:, 0])
    w = vals[:, 6]
    slots = [zero] * _SLOTS
    m2 = _cams(K, cam2w, ids[:, 1])
    r2 = _unproject(m2, vals[:, 2], vals[:, 3], dflat[ids[:, 3]] * vals[:, 5])
    if phase == 1:
        m1 = _cams(K, cam2w, ids[:, 0])
        r1 = _unproject(m1, vals[:, 0], vals[:, 1],
                        dflat[ids[:, 2]] * vals[:, 4])
        v = [(r1[3][i] - r2[3][i]) + _OFFSET for i in range(3)]
        dist = torch.sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2])
    else:
        P = proj.reshape(-1, 12)[ids[:, 0]]
        p2 = r2[3]
        hm = [((P[:, 4 * i] * p2[0] + P[:, 4 * i + 1] * p2[1])
               + P[:, 4 * i + 2] * p2[2]) + P[:, 4 * i + 3] for i in range(3)]
        small = torch.abs(hm[2]) < _ZMIN
        zc = torch.where(small, torch.full_like(hm[2], _ZMIN), hm[2])
        u, vv = hm[0] / zc, hm[1] / zc
        e0, e1 = (u - vals[:, 0]) + _OFFSET, (vv - vals[:, 1]) + _OFFSET
        dist = torch.sqrt(e0 * e0 + e1 * e1)
    base = dist + _EPS
    if side == 1:
        slots[_LOSS] = w * (torch.pow(base, g) - eps_g)
    coef = (coef_main * w) * (g * torch.pow(base, g_m1))
    h = coef / dist
    if phase == 1:
        gp = [h * v[i] if side == 1 else -(h * v[i]) for i in range(3)]
        cam, ray, doff = (m1, r1, vals[:, 4]) if side == 1 else (
            m2, r2, vals[:, 5])
        cam_slots, gz = _unproject_bwd(cam, ray, gp)
        slots[:16] = cam_slots
        ct = gz * doff
    else:
        ge0, ge1 = h * e0, h * e1
        gh = [ge0 / zc, ge1 / zc,
              torch.where(small, zero, -ge0 * (u / zc) + -ge1 * (vv / zc))]
        if side == 1:
            for i in range(3):
                for j in range(3):
                    slots[4 * i + j] = gh[i] * p2[j]
                slots[4 * i + 3] = gh[i]
            ct = zero
        else:
            gp = [(P[:, j] * gh[0] + P[:, 4 + j] * gh[1]) + P[:, 8 + j] * gh[2]
                  for j in range(3)]
            cam_slots, gz = _unproject_bwd(m2, r2, gp)
            slots[:16] = cam_slots
            ct = gz * vals[:, 5]
    return torch.stack(slots, 1), ct


def _side_partials(contrib, data: LossData, side: int):
    """`side_block`'s partials (nb, 17): each block's items, each thread's
    in turn from 0, then `_block_sum`; rows past the last camera's blocks
    are 0 (the kernel leaves them unwritten and never reads them)."""
    c, _, m, _ = data.dims
    plan = data.plan
    ii = data.ints()
    coff, bstart = ii[f"coff{side}"].long(), ii[f"bstart{side}"].long()
    dev = contrib.device
    b = torch.arange(plan.nb, device=dev)
    cam = torch.clamp(torch.searchsorted(bstart, b, right=True) - 1,
                      max=c - 1)
    live = b < bstart[c]
    lo = coff[cam] + (b - bstart[cam]) * plan.chunk
    hi = torch.minimum(lo + plan.chunk, coff[cam + 1])
    padded = torch.cat([contrib, contrib.new_zeros((1, _SLOTS))])
    acc = contrib.new_zeros((plan.nb, _THREADS, _SLOTS))
    t = torch.arange(_THREADS, device=dev)
    for j in range(plan.ipt):
        k = lo[:, None] + j * _THREADS + t[None]
        ok = live[:, None] & (k < hi[:, None])
        acc = acc + padded[torch.where(ok, k, torch.full_like(k, m))]
    return torch.where(live[:, None], _block_sum(acc),
                       torch.zeros_like(acc[:, 0]))


def _fallback(K, cam2w, depth, data: LossData):
    """`fallback_block` for every (camera, block of core points): (fbc
    (C, nj, 17), fbp (nj, P, 12), fbd (C * S,))."""
    c, s, _, p = data.dims
    nj = data.plan.nj
    ii, ff = data.ints(), data.floats()
    gd, gd_m1, eps_gd = _gammas(data)
    coef_fb = ff["scal"][4]
    dev = depth.device
    fbc = depth.new_zeros((c, nj, _SLOTS))
    fbp = depth.new_zeros((nj, p, _PAIR_SLOTS))
    fbd = depth.new_zeros((c * s,))
    pad = nj * _THREADS - s
    padded = lambda x: torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    poff, porder = ii["poff1"].tolist(), ii["porder1"].tolist()
    pimg2 = ii["pimg2"].tolist()
    pix = ff["core_pix"]
    for ci in range(c):
        cam = _cams(K, cam2w, torch.full((s,), ci, device=dev))
        ray = _unproject(cam, pix[:, 0], pix[:, 1], depth[ci])
        pt = ray[3]
        zero = torch.zeros_like(pt[0])
        gpt = [zero, zero, zero]
        lacc = zero
        for k in range(poff[ci], poff[ci + 1]):
            pk = porder[k]
            T2 = cam2w.reshape(-1, 16)[pimg2[pk]]
            r = ff["preds"][pk]
            v = [(pt[i] - (((T2[4 * i] * r[:, 0] + T2[4 * i + 1] * r[:, 1])
                            + T2[4 * i + 2] * r[:, 2]) + T2[4 * i + 3]))
                 + _OFFSET for i in range(3)]
            dist = torch.sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2])
            base = dist + _EPS
            wf = ff["fw"][pk]
            lacc = lacc + wf * (torch.pow(base, gd) - eps_gd)
            coef = (coef_fb * wf) * (gd * torch.pow(base, gd_m1))
            h = coef / dist
            pacc = []
            for i in range(3):
                gv = h * v[i]
                gpt[i] = gpt[i] + gv
                pacc += [-gv * r[:, 0], -gv * r[:, 1], -gv * r[:, 2], -gv]
            fbp[:, pk] = _block_sum(padded(torch.stack(pacc, 1))
                                    .view(nj, _THREADS, _PAIR_SLOTS))
        slots, gz = _unproject_bwd(cam, ray, gpt)
        fbd[ci * s:(ci + 1) * s] = gz
        contrib = torch.stack([zero + x for x in slots] + [zero + lacc], 1)
        fbc[ci] = _block_sum(padded(contrib).view(nj, _THREADS, _SLOTS))
    return fbc, fbp, fbd


def ga_loss_in_order(K: torch.Tensor, cam2w: torch.Tensor,
                     depth: torch.Tensor, proj: Optional[torch.Tensor],
                     alpha: torch.Tensor, data: LossData
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function with its arithmetic and summation order, in
    plain PyTorch: (loss, the flat gradient laid out as `_grad_layout`).
    The tests' picture of the kernel."""
    _check_inputs(K, cam2w, depth, proj, alpha, data)
    c, s, m, p = data.dims
    ii, ff = data.ints(), data.floats()
    scal = ff["scal"]
    g = alpha * 1.0 + (1.0 - alpha) * data.gamma
    g_m1, eps_g = g - 1.0, torch.pow(torch.full_like(g, _EPS), g)
    phase = data.phase
    parts, cts = {}, {}
    for side in (1, 2):
        contrib, cts[side] = _corr_items(
            phase, side, ii[f"ids{side}"], ff[f"vals{side}"], K, cam2w, depth,
            proj, g, g_m1, eps_g, scal[1])
        parts[side] = _side_partials(contrib, data, side)
    fallback = bool(scal[2] > 0)
    if fallback:
        fbc, fbp, fbd = _fallback(K, cam2w, depth, data)

    # finalize: the depth rows
    def runs(side):
        off = ii[f"off{side}"].long()
        return _seg_sum(cts[side], off[:-1], off[1:] - off[:-1])

    gdepth = runs(1) + runs(2) if phase == 1 else runs(2)
    if fallback:
        gdepth = gdepth + fbd

    # the camera entries: the side partials of each camera, slot by slot
    def side_sums(side, slots):
        bstart = ii[f"bstart{side}"].long()
        nblk = bstart[1:] - bstart[:-1]
        width = int(nblk.max()) if c else 0
        k = torch.clamp(bstart[:-1, None] + torch.arange(width,
                                                         device=K.device),
                        max=max(data.plan.nb - 1, 0))
        live = torch.arange(width, device=K.device)[None] < nblk[:, None]
        rows = parts[side][k][:, :, slots]                 # (C, width, n)
        rows = torch.where(live[:, :, None], rows, torch.zeros_like(rows))
        return _warp_sum(rows.permute(0, 2, 1).reshape(-1, width)).view(
            c, len(slots))

    cam_slots = list(range(16))
    cams = (side_sums(1, cam_slots) + side_sums(2, cam_slots)
            if phase == 1 else side_sums(2, cam_slots))
    if fallback:
        cams = cams + _warp_sum(fbc[:, :, :16].permute(0, 2, 1)
                                .reshape(c * 16, -1)).view(c, 16)
        # the pair partials of the pairs whose second camera is c, in the
        # order porder2, each pair's nj blocks in turn
        poff2, porder2 = ii["poff2"].tolist(), ii["porder2"].long()
        pair_rows = []
        for ci in range(c):
            sel = porder2[poff2[ci]:poff2[ci + 1]]
            pair_rows.append(fbp[:, sel].permute(1, 0, 2).reshape(-1, 12).T)
        width = max(r.shape[1] for r in pair_rows)
        pair_rows = torch.stack([torch.cat([r, r.new_zeros(
            (12, width - r.shape[1]))], 1) for r in pair_rows])
        pairs = _warp_sum(pair_rows.reshape(c * 12, width)).view(c, 12)
        cams = torch.cat([cams[:, :4], cams[:, 4:] + pairs], 1)
    gK = K.new_zeros((c, 9))
    gK[:, list(_K_ENTRIES)] = cams[:, :4]
    gcam = torch.cat([cams[:, 4:], cams.new_zeros((c, 4))], 1)
    flat = [gK.reshape(-1), gcam.reshape(-1)]
    if phase == 2:
        flat.append(side_sums(1, list(range(12))).reshape(-1))
    flat.append(gdepth)

    main = _warp_sum(parts[1][:, _LOSS][None])[0]
    loss = main / scal[0]
    if fallback:
        reg = _warp_sum(fbc[:, :, _LOSS].reshape(1, -1))[0] / scal[3]
    else:
        reg = torch.zeros_like(main)
    loss = loss + data.weight_d * reg
    return loss, torch.cat(flat)

