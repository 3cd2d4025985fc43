"""The GA's fused correspondence losses (`alignment/ga_loss.py`) on the CPU:
`ga_loss_in_order`, the kernel's arithmetic and summation order in
PyTorch, against the autograd chain of the port's plain losses
(`ga._loss_3d`, `ga._loss_2d`, `ga._loss_dust3r` on `ga._core_pts3d`) and
against `jax.vjp` of the JAX package's losses, on tests/test_torch_ga.py's
planted sphere scene at a perturbed start. Where a gradient is taken
through proj = K @ w2c[:, :3], it is the vector-Jacobian product with the
kernel's gradient views (tests/torch_ga_scene.py's `in_order_grads`).

Cases: both phases, with the dust3r fallback active (two pairs below the
matching threshold), with every pair matched (the fallback's weight 0, its
kernel blocks idle), with two cameras frozen (the weights carry the
freeze), with a failed pair whose two cameras are frozen (no fallback
weight although a match failed), at the JAX package's 512 px operating point
(10 cameras, 368,640 correspondences: several blocks a camera, four
correspondences a thread), and at the benchmark's recon shapes (six views
of 224 x 160 and of 512 x 384, `torch_ga_scene.condensed_case`).

Bounds (float32): the loss to 1e-6 relative (the same terms, summed in
another order), each gradient within 1e-5 of its largest magnitude (the
same derivatives written by hand, their products rounded in another
order, the per-camera sums of thousands of terms in another order):
against the chain, the gradients with respect to the fused loss's inputs
(K, cam2w, depth, and proj in phase 2); against JAX, whose `_loss_2d`
takes w2c, with respect to (K, w2c, cam2w, depth) through proj = K @
w2c[:, :3]. The schedule, the launch shape and the
functions' checks are held exactly.

A GA phase of 12 steps of the kernels' order in PyTorch
(`ga_step.ga_step_in_order`) against the same phase on the CPU's route
(`ga._Phase.steps`, the losses' chain): both phases, with the fallback
active, with shared intrinsics, and with the lora basis; within 1e-4 of
each output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_ga_scene import (STEP_CASES, condensed_case, ga_scene,
                            in_order_grads, step_phase)
from torch_threads import one_torch_thread  # noqa: F401

from starst3r_tpu.alignment import ga as jga
from starst3r_tpu.config import GAConfig as JGAConfig

from starst3r_tpu_torch.alignment import ga
from starst3r_tpu_torch.alignment import ga_loss as gl
from starst3r_tpu_torch.alignment import ga_step as gs
from starst3r_tpu_torch.config import GAConfig
from starst3r_tpu_torch.utils.synthetic import synthetic_ga_scene

LOSS_RTOL = 1e-6
GRAD_SCALED_TOL = 1e-5
ALPHA = 0.7
CASES = ("fallback", "all_ok", "frozen", "frozen_failed_pair")


def _case(name):
    """(CondensedData, mst, freeze) of a case."""
    data, mst = ga_scene(4)
    freeze = None
    if name == "all_ok":
        data = data._replace(
            pair_matching_ok=np.ones_like(data.pair_matching_ok))
    elif name == "frozen":
        freeze = np.array([True, True, False, False])
    elif name == "frozen_failed_pair":
        ok = np.ones_like(data.pair_matching_ok)
        both = (data.pair_img1 <= 1) & (data.pair_img2 <= 1)
        ok[np.flatnonzero(both)[0]] = False
        data = data._replace(pair_matching_ok=ok)
        freeze = np.array([True, True, False, False])
    return data, mst, freeze


def _start(data, mst, cfg, freeze, seed=0):
    """The port's state and (K, w2c, cam2w, depth) at a perturbed start."""
    state = ga.make_state(data, mst, cfg, freeze, device="cpu")
    g = torch.Generator().manual_seed(seed)
    params = ga.GAParams(*[p + 0.05 * torch.randn(p.shape, generator=g)
                           for p in ga.init_params(data, device="cpu")])
    return state, [t.detach() for t in ga.make_K_cam_depth(params, state)]


def _inputs(tensors, phase):
    """The fused loss's inputs: K, cam2w, depth, and in phase 2 proj =
    K @ w2c[:, :3]."""
    K, w2c, cam2w, depth = tensors
    return [K, cam2w, depth] + ([K @ w2c[:, :3]] if phase == 2 else [])


def _plain(state, phase, cfg, alpha):
    """The losses' autograd chain of (K, cam2w, depth[, proj])."""
    gamma = cfg.gamma1 if phase == 1 else cfg.gamma2

    def loss(K, cam2w, depth, proj=None):
        if phase == 1:
            main = ga._loss_3d(K, cam2w, depth, state, gamma, alpha)
        else:
            main = ga._loss_2d(K, cam2w, depth, proj, state, gamma, alpha)
        reg = ga._loss_dust3r(ga._core_pts3d(K, cam2w, depth, state), cam2w,
                              state, cfg.gamma_d)
        return main + cfg.loss_dust3r_w * reg
    return loss


def _loss_data(state, phase, cfg):
    return gl.make_loss_data(
        state, phase, cfg.gamma1 if phase == 1 else cfg.gamma2, cfg.gamma_d,
        cfg.loss_dust3r_w)


def _grads(fn, tensors):
    """fn's loss and its gradient with respect to each of ``tensors``, 0
    where one is unused."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    loss = fn(*leaves)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(t) if g is None else g
                                  for t, g in zip(tensors, grads)]


def _in_order(data, alpha, tensors, inputs_of):
    """`ga_loss_in_order`'s loss at ``inputs_of(*tensors)`` (K, cam2w,
    depth, proj or None) and its gradient with respect to each of
    ``tensors``, 0 where one is unused."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    loss, grads = in_order_grads(inputs_of(*leaves), leaves, alpha, data)
    return float(loss), [torch.zeros_like(t) if g is None else g
                         for t, g in zip(tensors, grads)]


def _check(loss, grads, want_loss, want_grads):
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        w = torch.as_tensor(np.array(w), dtype=torch.float64)
        err = float((g.double() - w).abs().max())
        assert err <= GRAD_SCALED_TOL * float(w.abs().max()), (i, err)


def _against_the_chain(state, tensors, phase, cfg, data=None):
    """The fused loss's loss and gradients (K, cam2w, depth, proj) against
    the chain's at alpha ALPHA."""
    alpha = torch.tensor(ALPHA)
    inputs = _inputs(tensors, phase)
    loss, grads = _in_order(data or _loss_data(state, phase, cfg), alpha,
                            inputs, lambda K, cam2w, depth, proj=None: (
                                K, cam2w, depth, proj))
    want_loss, want = _grads(_plain(state, phase, cfg, alpha), inputs)
    _check(loss, grads, want_loss, want)


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_in_order_matches_the_plain_chain(case, phase):
    data, mst, freeze = _case(case)
    cfg = GAConfig()
    state, tensors = _start(data, mst, cfg, freeze)
    _against_the_chain(state, tensors, phase, cfg)
    cf = float(gl.make_loss_data(state, phase, 1.0, 1.0, 1.0)
               .floats()["scal"][2])
    assert (cf > 0) == (case in ("fallback", "frozen"))


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_in_order_matches_jax(case, phase):
    """Through proj = K @ w2c[:, :3], as the JAX `_loss_2d` takes w2c: the
    gradients with respect to (K, w2c, cam2w, depth)."""
    data, mst, freeze = _case(case)
    cfg = GAConfig()
    state, tensors = _start(data, mst, cfg, freeze)
    loss, grads = _in_order(
        _loss_data(state, phase, cfg), torch.tensor(ALPHA), tensors,
        lambda K, w2c, cam2w, depth: (
            K, cam2w, depth, K @ w2c[:, :3] if phase == 2 else None))
    jstate = jga.make_state(data, mst, JGAConfig(), freeze)
    gamma = cfg.gamma1 if phase == 1 else cfg.gamma2
    alpha = jnp.float32(ALPHA)

    def f(K, w2c, cam2w, depth):
        if phase == 1:
            main = jga._loss_3d(K, cam2w, depth, jstate, gamma, alpha)
        else:
            main = jga._loss_2d(K, cam2w, depth, w2c, jstate, gamma, alpha)
        reg = jga._loss_dust3r(jga._core_pts3d(K, cam2w, depth, jstate),
                               cam2w, jstate, cfg.gamma_d)
        return main + cfg.loss_dust3r_w * reg

    want_loss, vjp = jax.vjp(f, *[jnp.asarray(t.numpy()) for t in tensors])
    _check(loss, grads, float(want_loss), vjp(jnp.float32(1.0)))


def test_in_order_matches_the_plain_chain_at_the_512px_point():
    """Phase 1 at the JAX package's 512 px operating point, with two
    failed pairs: several blocks a camera and four correspondences a
    thread, so the schedule's runs and each thread's turns are exercised."""
    data, mst, _, _ = synthetic_ga_scene(
        n_cams=10, hw=512, focal=720.0, subsample=8, anchored=True,
        orbit=True, sph_r=1.2, spread=0.2)
    ok = np.ones_like(data.pair_matching_ok)
    ok[[3, 40]] = False
    data = data._replace(pair_matching_ok=ok)
    cfg = GAConfig()
    state, tensors = _start(data, mst, cfg, None)
    fused = gl.make_loss_data(state, 1, cfg.gamma1, cfg.gamma_d,
                              cfg.loss_dust3r_w)
    assert fused.plan.ipt == 4 and fused.dims == (10, 4096, 368_640, 90)
    _against_the_chain(state, tensors, 1, cfg, fused)


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("hw", [(160, 224), (384, 512)])
def test_in_order_matches_the_plain_chain_at_the_recon_shapes(hw, phase):
    """The benchmark's recon cells' condensed shapes: six views of 224 x
    160 (S = 560) and 512 x 384 (S = 3,072), 30 pairs, S correspondences a
    pair, two pairs below the matching threshold."""
    data, mst = condensed_case(*hw)
    cfg = GAConfig()
    state, tensors = _start(data, mst, cfg, None)
    _against_the_chain(state, tensors, phase, cfg)


@pytest.mark.parametrize("m,s,c", [(0, 64, 1), (9_408, 784, 4),
                                   (20_000, 560, 6), (135_168, 3_072, 6),
                                   (368_640, 4_096, 10), (5_000_000, 64, 3)])
def test_plan(m, s, c):
    """ipt doubles while a side would still have two blocks an SM at
    twice the chunk, up to 8; nb covers every camera's run of chunks."""
    plan = gl.loss_plan(m, s, c)
    assert plan.ipt in (1, 2, 4, 8)
    if plan.ipt > 1:
        assert m >= plan.chunk * gl._BLOCKS_PER_SIDE
    if plan.ipt < gl._MAX_IPT:
        assert m < 2 * plan.chunk * gl._BLOCKS_PER_SIDE
    assert (plan.nb - c) * plan.chunk >= m > (plan.nb - c - 1) * plan.chunk \
        or m == 0
    assert plan.nj * gl._THREADS >= s > (plan.nj - 1) * gl._THREADS


@pytest.mark.parametrize("case", ["fallback", "frozen"])
def test_schedule_covers_every_item_once(case):
    """Each side's blocks: every sorted position in exactly one block of its
    own camera, each block within the plan's chunk, the blocks within nb;
    the items in each side's depth-row order with that side's CSR."""
    data, mst, freeze = _case(case)
    cfg = GAConfig()
    state, _ = _start(data, mst, cfg, freeze)
    fused = gl.make_loss_data(state, 1, 1.0, 1.0, 1.0)
    c, s, m, _ = fused.dims
    ii = fused.ints()
    for side in (1, 2):
        ids = ii[f"ids{side}"].numpy()
        rows = ids[:, 1 + side]
        assert (np.diff(rows) >= 0).all()
        off = ii[f"off{side}"].numpy()
        assert (off == np.searchsorted(rows, np.arange(c * s + 1))).all()
        coff, bstart = ii[f"coff{side}"].numpy(), ii[f"bstart{side}"].numpy()
        seen = np.zeros(m, int)
        for cam in range(c):
            assert (ids[coff[cam]:coff[cam + 1], side - 1] == cam).all()
            for b in range(bstart[cam], bstart[cam + 1]):
                lo = coff[cam] + (b - bstart[cam]) * fused.plan.chunk
                seen[lo:min(lo + fused.plan.chunk, coff[cam + 1])] += 1
        assert (seen == 1).all() and bstart[c] <= fused.plan.nb


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", ["fallback", "shared", "lora"])
def test_in_order_phase_matches_the_chain_phase(case, phase):
    """12 steps of the kernels' order in PyTorch against 12 steps of the
    CPU's route (the losses' chain under autograd), from one start: K,
    the core depth and the poses in the root camera's frame (the root's
    own pose is a free gauge that Adam moves by float noise), each scaled
    by its largest magnitude, and the last loss within 1e-4 of the
    chain's (Adam's normalised steps carry the gradients' float32
    differences into the params). "fallback": the GA's start on the
    scene with two failed pairs; "shared" and "lora": STEP_CASES' cases
    at their perturbed start. (STEP_CASES' "frozen", cameras 1 and 3
    frozen, is chaotic here: its poses part by 7.8e-4 of their largest
    magnitude in phase 2, as tests/test_torch_cuda.py's
    test_ga_on_cuda_matches_cpu finds of that frozen set.)"""
    if case == "fallback":
        data, mst, _ = _case(case)
        cfg = GAConfig(niter1=12, niter2=12)
        state = ga.make_state(data, mst, cfg, device="cpu")
        gamma = cfg.gamma1 if phase == 1 else cfg.gamma2
        phase_of = lambda: ga._Phase(ga.init_params(data, device="cpu"),
                                     state, 12, cfg.lr1, cfg.lr_end, gamma,
                                     phase, cfg)
        ph = phase_of()
        step_data = gs.make_step_data(state, phase, 12, cfg.lr1, cfg.lr_end,
                                      cfg)
        loss_data = _loss_data(state, phase, cfg)
    else:
        ph, step_data, loss_data = step_phase(case, phase)
        phase_of = lambda: step_phase(case, phase)[0]
    kw = STEP_CASES.get(case, ({},))[0]
    mst_root = ph.state.root
    tensors = [t.detach().clone() for t in ph.tensors()]
    for _ in range(12):
        tensors = gs.ga_step_in_order(tensors, step_data, loss_data)[0]
    chain = phase_of()
    chain.steps(12)
    out = []
    for params, last in ((ga.GAParams(*tensors[:6]), tensors[20]),
                         (chain.params, chain.last_loss)):
        with torch.no_grad():
            K, _, cam2w, depth = ga.make_K_cam_depth(
                params, ph.state, kw.get("depth_mode", "add"),
                kw.get("shared_intrinsics", False),
                kw.get("exp_depth", False))
        rel = (torch.linalg.inv(cam2w[mst_root].double())[None]
               @ cam2w.double())
        out.append(((K, rel, depth), float(last)))
    (got, got_loss), (plain, plain_loss) = out
    assert int(tensors[18]) == int(chain.count) == 12
    assert abs(got_loss - plain_loss) <= 1e-4 * abs(plain_loss)
    for g, w in zip(got, plain):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.double() - w.double()).abs().max()) <= 1e-4 * scale


def test_function_refuses_what_the_kernel_does_not_take():
    data, mst, _ = _case("fallback")
    cfg = GAConfig()
    state, (K, w2c, cam2w, depth) = _start(data, mst, cfg, None)
    alpha = torch.tensor(ALPHA)
    one = gl.make_loss_data(state, 1, cfg.gamma1, cfg.gamma_d, 0.01)
    two = gl.make_loss_data(state, 2, cfg.gamma2, cfg.gamma_d, 0.01)
    proj = K @ w2c[:, :3]
    with pytest.raises(ValueError, match="phase 1 takes no proj"):
        gl.ga_loss_in_order(K, cam2w, depth, proj, alpha, one)
    with pytest.raises(ValueError, match="proj must be"):
        gl.ga_loss_in_order(K, cam2w, depth, None, alpha, two)
    with pytest.raises(ValueError, match="depth must be"):
        gl.ga_loss_in_order(K, cam2w, depth[:, :-1], None, alpha, one)
    with pytest.raises(ValueError, match="alpha must be"):
        gl.ga_loss_in_order(K, cam2w, depth, None, alpha.double(), one)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gl.ga_loss_cuda(K, cam2w, depth, None, alpha, one)
