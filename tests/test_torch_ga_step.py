"""The GA step's two kernels in PyTorch (`alignment/ga_step.py`) on the
CPU: `reparam_in_order` and `update_in_order`, the kernels' arithmetic and
summation order around the fused loss's (`ga_step_in_order`), against the
same step taken with autograd (`ga.make_K_cam_depth`, the vector-Jacobian
product with `ga_loss_in_order`'s gradient, the masked Adam of
`ga._Phase.update`: tests/torch_ga_scene.py's `in_order_loss_step`), on
tests/test_torch_ga.py's planted sphere scene at a perturbed start; and
`ga._Phase.step`, which takes CPU tensors through the losses' chain and
refuses any device but the CPU and the card.

Cases: both phases; frozen cameras; shared intrinsics; exp depth; the
"mul" depth mode; the lora basis (with and without exp depth); opt_pp off
and opt_depth on (each leaf's mask); step 1, where every log-size is 0
and all cameras tie for the smallest size (`torch.min`'s backward splits
the gradient evenly among them); a non-finite loss, and a stopped phase,
which keep the params, the moments and the loss.

Bounds (float32): the reparameterisation's outputs (K, cam2w, w2c, proj,
depth) within 1e-6 of each one's largest magnitude. After one step from a
mid-run state, whose moments are drawn at each leaf's gradient scale, each
leaf's update within 1e-5 of its largest magnitude, and mu and nu within
2e-5 of theirs (the same derivatives written out by hand, rounded in
another order: the chain's products cancel, and the two float32 routes sit
up to 1e-5 from the float64 step, often on opposite sides: 1.5e-5 apart
at most over these cases); each of them no farther from the float64
autograd step (the losses' plain chain, in float64) than twice the
autograd float32 step is, never held below its own bound. At step 1
Adam's update is +-lr wherever a gradient is not 0, so the root camera's
pose, a free gauge whose gradient is rounding noise (tests/
test_torch_ga.py), moves +-lr by its sign: there mu and nu (the masked
gradient, its square) are held to their bound, and not the params.
"""

import pytest
import torch
from torch_ga_scene import (MID_COUNT, STEP_CASES, STEP_NITER,
                            in_order_loss_step, mid_run, step_phase)
from torch_threads import one_torch_thread  # noqa: F401

from starst3r_tpu_torch.alignment import ga
from starst3r_tpu_torch.alignment import ga_loss as gl
from starst3r_tpu_torch.alignment import ga_step as gs

OUT_TOL = 1e-6
STEP_TOL = 1e-5
MOMENT_TOL = 2e-5
LEAF_NAMES = [f"{kind} {leaf}" for kind in ("param", "mu", "nu")
              for leaf in gs._LEAVES]


def _state(ph):
    return [t.detach().clone() for t in ph.tensors()]


def _reference_step(ph, loss_data):
    """The phase's step through autograd around the fused loss's order in
    PyTorch, from its state: the new state."""
    in_order_loss_step(ph, loss_data)
    return _state(ph)


def _scaled(got, want):
    got, want = got.double(), want.double()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1e-30))


def _moves(new, old):
    """What one step changed: each param leaf's update, mu and nu."""
    return ([(n - o).double() for n, o in zip(new[:6], old[:6])]
            + [n.double() for n in new[6:18]])


def _check_outputs(fwd, ph, cfg_kw):
    kw = STEP_CASES[cfg_kw][0]
    with torch.no_grad():
        K, w2c, cam2w, depth = ga.make_K_cam_depth(
            ph.params, ph.state, kw.get("depth_mode", "add"),
            kw.get("shared_intrinsics", False), kw.get("exp_depth", False))
    want = {"K": K, "w2c": w2c, "cam2w": cam2w, "depth": depth,
            "proj": K @ w2c[:, :3]}
    for name, w in want.items():
        got = fwd[name].reshape(w.shape)
        assert _scaled(got, w) <= OUT_TOL, name


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_in_order_step_matches_the_autograd_step(case, phase):
    """One step from a mid-run state: the outputs, each leaf's update, mu
    and nu against the autograd step, and against the float64 step."""
    ph, data, loss_data = step_phase(case, phase)
    mid_run(ph)
    old = _state(ph)
    new, fwd, _, _ = gs.ga_step_in_order(old, data, loss_data)
    _check_outputs(fwd, ph, case)
    want = _reference_step(ph, loss_data)
    ph64, _, _ = step_phase(case, phase, dtype=torch.float64)
    mid_run(ph64)
    old64 = _state(ph64)
    ph64.step()
    ref = _moves(_state(ph64), old64)
    got, plain = _moves(new, old), _moves(want, old)
    for i, (name, g, p, r) in enumerate(zip(LEAF_NAMES, got, plain, ref)):
        tol = STEP_TOL if i < 6 else MOMENT_TOL
        assert _scaled(g, p) <= tol, name
        assert _scaled(g, r) <= max(2 * _scaled(p, r), tol), name
    assert int(new[18]) == MID_COUNT + 1 and not bool(new[19])
    # the fused loss at outputs 1e-7 apart
    assert abs(float(new[20]) - float(want[20])) <= OUT_TOL * abs(
        float(want[20]))


@pytest.mark.parametrize("phase", [1, 2])
@pytest.mark.parametrize("case", ["default", "frozen", "lora"])
def test_first_step_ties_and_masks(case, phase):
    """Step 1 from the GA's start: every log-size is 0, so all cameras tie
    for the smallest size. The masked gradient (mu) and its square (nu)
    against the autograd step's; the masked leaves' moments stay 0."""
    ph, data, loss_data = step_phase(case, phase, perturb=False)
    assert bool((ph.params.log_sizes == 0).all())
    old = _state(ph)
    new, fwd, _, _ = gs.ga_step_in_order(old, data, loss_data)
    _check_outputs(fwd, ph, case)
    want = _reference_step(ph, loss_data)
    for i in range(6, 18):
        assert _scaled(new[i], want[i]) <= MOMENT_TOL, LEAF_NAMES[i]
        if not bool(want[i].any()):
            assert not bool(new[i].any()), LEAF_NAMES[i]
    assert bool(new[6 + 4].any())   # log_sizes moved: the tie's share
    if phase == 1:
        assert not bool(new[6].any()) and not bool(new[7].any())


@pytest.mark.parametrize("phase", [1, 2])
def test_non_finite_loss_freezes_the_state(phase):
    """A non-finite loss, or a phase stopped before, keeps the params, the
    moments and the last loss; the count advances and the flag is set."""
    ph, data, loss_data = step_phase("default", phase)
    mid_run(ph)
    old = _state(ph)
    fwd = gs.reparam_in_order(old[:6], old[18], data)
    c, s, _ = data.dims
    loss, grads = gl.ga_loss_in_order(
        fwd["K"].view(c, 3, 3), fwd["cam2w"].view(c, 4, 4), fwd["depth"],
        fwd["proj"].view(c, 3, 4) if phase == 2 else None,
        fwd["alpha"].view(()), loss_data)
    for bad in (float("nan"), float("inf")):
        new = gs.update_in_order(old, torch.tensor(bad), grads, fwd, data)
        assert all(torch.equal(a, b) for a, b in zip(new[:18], old[:18]))
        assert int(new[18]) == MID_COUNT + 1 and bool(new[19])
        assert torch.equal(new[20], old[20])
    stopped = old[:19] + [torch.tensor(True), torch.tensor(0.25)]
    new = gs.update_in_order(stopped, loss, grads, fwd, data)
    assert all(torch.equal(a, b) for a, b in zip(new[:18], old[:18]))
    assert bool(new[19]) and float(new[20]) == 0.25
    new = gs.update_in_order(old, loss, grads, fwd, data)
    assert not bool(new[19]) and torch.equal(new[20], loss)


def test_alpha_and_lr_follow_the_count():
    """alpha = 1 - count / niter as the phase computes it, at every count
    of the phase."""
    ph, data, _ = step_phase("default", 1)
    for count in range(STEP_NITER):
        fwd = gs.reparam_in_order(list(ph.params), torch.tensor(count), data)
        frac = torch.tensor(count).to(torch.float32) / STEP_NITER
        assert torch.equal(fwd["alpha"], (1.0 - frac).reshape(1))


def test_step_data_layout_and_checks():
    """The statics and the edges as the kernels read them; a state of the
    wrong shape or dtype is refused; a CPU tensor is refused by the card's
    step."""
    ph, data, loss_data = step_phase("lora", 2)
    c, s, k = data.dims
    assert (c, s, k) == (4, 64, 16)
    st = data.statics()
    assert torch.equal(st["W"], ph.state.imsizes[:, 0])
    assert torch.equal(st["free"], torch.ones(4))
    assert torch.equal(data.basis(), ph.state.depth_basis)
    ints = data.istat.tolist()
    assert ints[:2] == [ph.state.root, c - 1]
    assert list(zip(ints[2:2 + c - 1], ints[2 + c - 1:])) == list(
        zip(ph.state.edge_parent, ph.state.edge_child))
    buf = gs.step_buffer(data)
    views = gs.fwd_views(buf, data)
    assert views["gcc"].shape == (c, k) and views["depth"].shape == (c, s)
    tensors = _state(ph)
    gs._check_state(tensors, data)
    with pytest.raises(ValueError, match="core_depth"):
        gs._check_state(tensors[:5] + [tensors[5][:, :-1]] + tensors[6:],
                        data)
    with pytest.raises(ValueError, match="int64"):
        gs._check_state(tensors[:18] + [tensors[18].int()] + tensors[19:],
                        data)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gs.ga_step_cuda(tensors, buf, data, loss_data)


def test_step_refuses_other_devices():
    """`_Phase.step` takes CUDA tensors through the step's kernels and CPU
    tensors through the losses' chain; a phase on any other device
    raises."""
    ph, _, _ = step_phase("default", 1)
    meta = lambda t: t.to("meta")
    state = ph.state._replace(**{
        k: meta(v) for k, v in ph.state._asdict().items()
        if isinstance(v, torch.Tensor)})
    on_meta = ga._Phase(ga.GAParams(*map(meta, ph.params)), state,
                        STEP_NITER, ph.lr_base, ph.lr_end, ph.gamma, 1,
                        ph.cfg)
    assert on_meta.device.type == "meta" and on_meta.loss_data is None
    with pytest.raises(ValueError, match="no GA step for device meta"):
        on_meta.step()
