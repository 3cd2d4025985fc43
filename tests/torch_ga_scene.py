"""The GA scene of tests/test_torch_ga.py built from the port's own
`utils.synthetic` (equal bit for bit to the JAX package's), for the port's
GA tests that must not import JAX (tests/test_torch_cuda.py).

The planted-pose sphere scene (anchored endpoints, 4 cameras, 64 px, an
8 x 8 core grid), with two pairs marked as failed matches so the dust3r
fallback loss is live, a noisy fallback target and scaled confidences.

Also the shapes of the JAX GA's six row gathers on the main path, and
rows long and short enough for each of the kernel's launch shapes
(`gather_case`), and the six gathers' indices on a GAState
(`state_sites`), for the row-sum kernel's CPU and GPU tests; the GA
step's cases (`step_phase`, `mid_run`), and the fused loss's order in
PyTorch under autograd (`in_order_grads`, `in_order_loss_step`) as the
reference the step's tests hold the kernels' order to.
"""

import numpy as np

from starst3r_tpu_torch.utils.synthetic import synthetic_ga_scene


def ga_scene(n_cams=4, seed=0):
    """(CondensedData, mst) of tests/test_torch_ga.py::_scene."""
    data, mst, _, _ = synthetic_ga_scene(n_cams=n_cams, hw=64, subsample=8,
                                         focal=90.0, anchored=True)
    rng = np.random.default_rng(seed)
    p = data.pair_img1.shape[0]
    ok = np.ones(p, bool)
    ok[rng.choice(p, size=2, replace=False)] = False
    s = data.core_pix.shape[0]
    preds = rng.normal(size=(p, s, 3)).astype(np.float32) * 0.05
    preds[..., 2] += 4.0
    data = data._replace(
        pair_matching_ok=ok, preds21_pts=preds,
        preds21_conf=rng.uniform(1, 2, size=(p, s)).astype(np.float32),
        corr_conf=(data.corr_conf * rng.uniform(1, 3, size=data.corr_conf
                                                .shape)).astype(np.float32))
    return data, mst


GATHER_S = 784          # core points of a 224 px view at subsample 8
GATHER_M = 20_000       # correspondences, about what the main path's GA holds
GATHER_SITES = ("depth", "K", "cam2w", "proj", "pair_cam2w", "pair_pts3d")


# one camera row of the 512 px operating point's correspondences, rounded
# up (tests/test_ga_groundtruth.py::test_ga_512px_scale_memory: 36,864 a
# camera, 368,640 in all)
LONG_ROW = 368_640


def gather_case(name, c=6, seed=0, m=GATHER_M, s=GATHER_S):
    """(R, idx (M,) int64, ct (M, D) float32) of one of the JAX GA's six
    `_gather_rows` sites at C = c cameras, S = s core points, M = m
    correspondences and P = c (c - 1) pairs; or "empty_rows", a
    depth-shaped index over the first two cameras' rows only; "one_row",
    an index whose entries all fall in one of the C rows; "long_row", one
    row of LONG_ROW entries (the kernel splits it over a cluster of
    blocks); "split_short_row", a row of 40,000 entries beside one of 3,
    shuffled (the kernel splits both rows alike, so a block of the short
    row's cluster gets no entry)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, c, m)
    pairs = rng.integers(0, c, c * (c - 1))
    r, d, idx = {
        "depth": (c * s, 1, img * s + rng.integers(0, s, m)),
        "K": (c, 9, img), "cam2w": (c, 16, img), "proj": (c, 12, img),
        "pair_cam2w": (c, 16, pairs), "pair_pts3d": (c, s * 3, pairs),
        "empty_rows": (c * s, 1, rng.integers(0, 2 * s, 500)),
        "one_row": (c, 16, np.full(m, 2)),
        "long_row": (c, 16, np.full(LONG_ROW, 1)),
        "split_short_row": (c, 16, np.random.default_rng(seed + 1)
                            .permutation(np.repeat([0, 3], [40_000, 3])))
    }[name]
    ct = (3.0 * rng.normal(size=(len(idx), d))).astype(np.float32)
    return r, idx.astype(np.int64), ct


def state_sites(state):
    """{site: (R, D, idx)} of the JAX GA's six `_gather_rows` sites on a
    GAState's own indices: the correspondences' depth rows img * S + idx
    over the C * S rows of the core depth, their first cameras (K, cam2w,
    proj), and the pairs' cameras (cam2w by the second, the core points
    by the first)."""
    c, s = state.imsizes.shape[0], state.core_pix.shape[0]
    img1 = state.corr_img1
    return {"depth": (c * s, 1, img1 * s + state.corr_idx1),
            "K": (c, 9, img1), "cam2w": (c, 16, img1),
            "proj": (c, 12, img1), "pair_cam2w": (c, 16, state.pair_img2),
            "pair_pts3d": (c, 3 * s, state.pair_img1)}


def condensed_case(h, w, n_views=6, seed=0, subsample=8):
    """(CondensedData, mst) at the condensed shape of ``n_views`` h x w
    views (S = (h / subsample) (w / subsample) core points, every ordered
    pair, S correspondences a pair with anchored endpoints), from random
    numbers: median depths 2-5 and core depths within 10% of them (so the
    reparameterised cameras see every point well in front of them), two
    pairs below the matching threshold so the fallback is live, an MST
    chain from camera 0. The shapes of the benchmark's recon cells (224 x
    160: S = 560; 512 x 384: S = 3,072) for the fused loss's tests."""
    from starst3r_tpu_torch.alignment.condense import CondensedData
    rng = np.random.default_rng(seed)
    c = n_views
    hs, ws = h // subsample, w // subsample
    s = hs * ws
    yy, xx = np.mgrid[0:hs, 0:ws]
    core_pix = np.stack([xx.reshape(-1), yy.reshape(-1)], -1).astype(
        np.float32) * subsample + subsample // 2
    pairs = [(i, j) for i in range(c) for j in range(c) if i != j]
    p = len(pairs)
    pair_img1 = np.array([a for a, _ in pairs], np.int32)
    pair_img2 = np.array([b for _, b in pairs], np.int32)
    m = p * s
    corr_pair = np.repeat(np.arange(p), s).astype(np.int32)
    corr_idx1 = rng.integers(0, s, m).astype(np.int32)
    corr_idx2 = rng.integers(0, s, m).astype(np.int32)
    ok = np.ones(p, bool)
    ok[rng.choice(p, size=2, replace=False)] = False
    jitter = lambda idx: (core_pix[idx] + rng.uniform(
        -subsample / 2, subsample / 2, (m, 2))).astype(np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    data = CondensedData(
        imsizes=f32(np.tile([w, h], (c, 1))),
        pps=f32(0.5 + rng.uniform(-0.02, 0.02, (c, 2))),
        base_focals=f32(rng.uniform(0.9, 1.1, c) * max(h, w)),
        core_depth=f32(rng.uniform(0.9, 1.1, (c, s))),
        median_depths=f32(rng.uniform(2.0, 5.0, c)),
        core_pix=core_pix,
        corr_img1=pair_img1[corr_pair], corr_idx1=corr_idx1,
        corr_img2=pair_img2[corr_pair], corr_idx2=corr_idx2,
        corr_conf=f32(rng.uniform(1.0, 3.0, m)), corr_pair=corr_pair,
        pair_img1=pair_img1, pair_img2=pair_img2, pair_matching_ok=ok,
        preds21_pts=f32(rng.normal(size=(p, s, 3)) * 0.3 + [0, 0, 3]),
        preds21_conf=f32(rng.uniform(1.0, 2.0, (p, s))),
        corr_pix1=jitter(corr_idx1), corr_pix2=jitter(corr_idx2),
        corr_doff1=f32(rng.uniform(0.9, 1.1, m)),
        corr_doff2=f32(rng.uniform(0.9, 1.1, m)))
    return data, (0, [(i, i + 1) for i in range(c - 1)])


# the GA step's cases (tests/test_torch_ga_step.py on the CPU, the kernels'
# GPU tests): name -> (GAConfig keywords, the frozen cameras, lora basis)
STEP_CASES = {
    "default": ({}, None, False),
    "frozen": ({}, (False, True, False, True), False),
    "shared": (dict(shared_intrinsics=True), None, False),
    "exp_depth": (dict(exp_depth=True, opt_depth=True), None, False),
    "mul": (dict(depth_mode="mul", opt_depth=True), None, False),
    "lora": (dict(opt_depth=True), None, True),
    "lora_exp": (dict(opt_depth=True, exp_depth=True), None, True),
    "opt_pp_off": (dict(opt_pp=False), None, False),
}
STEP_NITER = 20


def lora_inputs(data, k=16, seed=2):
    """(basis (C, S, k), coefficients (C, k)) of the scene's core depth
    (`alignment/spectral.py`, from random colours on the core grid)."""
    from starst3r_tpu_torch.alignment.spectral import (
        spectral_projection_of_depthmaps)
    c, s = data.core_depth.shape
    side = int(round(np.sqrt(s)))
    rng = np.random.default_rng(seed)
    colors = rng.uniform(size=(c, s, 3)).astype(np.float32)
    coeffs, basis = spectral_projection_of_depthmaps(
        colors, data.core_depth, (side, s // side), k=k)
    return np.asarray(basis, np.float32), np.asarray(coeffs, np.float32)


def step_phase(case, phase, device="cpu", dtype=None, perturb=True,
               scene=None):
    """A GA phase (`ga._Phase`) of a STEP_CASES case on ``device`` at a
    perturbed start (params + 0.05 N(0, 1), seed 0), its
    `ga_step.StepData` and its fused loss's `ga_loss.LossData` (the
    phase's own on the card). ``scene``: (CondensedData, mst), tests/
    test_torch_ga.py's 4-camera scene by default. ``dtype`` float64 casts
    the state and params (the chain's step in float64)."""
    import torch
    from starst3r_tpu_torch.alignment import ga, ga_loss, ga_step
    from starst3r_tpu_torch.config import GAConfig
    kw, freeze, lora = STEP_CASES[case]
    cfg = GAConfig(**kw)
    data, mst = scene if scene is not None else ga_scene(4)
    basis, coeffs = lora_inputs(data) if lora else (None, None)
    freeze = None if freeze is None else np.array(freeze)
    state = ga.make_state(data, mst, cfg, freeze, depth_basis=basis,
                          device=device)
    params = ga.init_params(data, device=device)
    if lora:
        params = params._replace(core_depth=torch.from_numpy(coeffs).to(
            device))
    if cfg.exp_depth:
        params = params._replace(core_depth=torch.log(torch.clamp(
            params.core_depth, min=1e-4)))
    if perturb:
        g = torch.Generator().manual_seed(0)
        params = ga.GAParams(*[
            p + 0.05 * torch.randn(p.shape, generator=g).to(device)
            for p in params])
    gamma, lr = (cfg.gamma1, cfg.lr1) if phase == 1 else (cfg.gamma2,
                                                          cfg.lr2)
    # the card's phase builds its own; the CPU's from the float32 state
    loss_data = None if state.corr_conf.is_cuda else ga_loss.make_loss_data(
        state, phase, gamma, cfg.gamma_d, cfg.loss_dust3r_w)
    if dtype == torch.float64:
        state = state._replace(**{
            k: v.double() for k, v in state._asdict().items()
            if isinstance(v, torch.Tensor) and v.is_floating_point()})
        params = ga.GAParams(*[p.double() for p in params])
    ph = ga._Phase(params, state, STEP_NITER, lr, cfg.lr_end, gamma, phase,
                   cfg)
    step_data = ga_step.make_step_data(state, phase, STEP_NITER, lr,
                                       cfg.lr_end, cfg)
    return ph, step_data, ph.loss_data if loss_data is None else loss_data


def in_order_grads(inputs, wrt, alpha, loss_data):
    """`ga_loss.ga_loss_in_order`'s loss at ``inputs`` (K, cam2w, depth,
    and proj or None, computed from ``wrt`` under autograd) and its
    gradient with respect to each of ``wrt`` (None where one is unused):
    the vector-Jacobian product of ``inputs`` with the fused loss's
    gradient views."""
    import torch
    from starst3r_tpu_torch.alignment import ga_loss
    c, s = loss_data.dims[:2]
    loss, flat = ga_loss.ga_loss_in_order(
        *[None if t is None else t.detach() for t in inputs], alpha,
        loss_data)
    views = ga_loss._views(flat, ga_loss._grad_layout(c, s,
                                                      loss_data.phase))
    pairs = [(t, views[name]) for t, name in zip(
        inputs, ("K", "cam2w", "depth", "proj")) if t is not None]
    return loss, torch.autograd.grad([t for t, _ in pairs], wrt,
                                     [v for _, v in pairs],
                                     allow_unused=True)


def in_order_loss_step(ph, loss_data):
    """One step of ``ph`` with the fused loss's order in PyTorch in place
    of the losses' chain: the reparameterisation (and proj in phase 2)
    under autograd, `in_order_grads` to the params, then the phase's
    masked Adam step (`ga._Phase.update`)."""
    from starst3r_tpu_torch.alignment import ga
    cfg = ph.cfg
    K, w2c, cam2w, depth = ga.make_K_cam_depth(
        ph.params, ph.state, cfg.depth_mode, cfg.shared_intrinsics,
        cfg.exp_depth)
    proj = K @ w2c[:, :3] if ph.phase == 2 else None
    loss, grads = in_order_grads((K, cam2w, depth, proj), ph.params,
                                 1.0 - ph._frac(), loss_data)
    ph.update(loss, grads)


MID_COUNT = 7


def mid_run(ph, seed=1):
    """Set the phase's count to MID_COUNT and its moments at each leaf's
    gradient scale: mu ~ 0.1 N(0, 1) max|g|, nu ~ 0.1 U(0.5, 1.5) max|g|^2
    (g: the autograd gradient at alpha 0.5), so one Adam step is a smooth
    function of the gradient everywhere, the root camera's gauge too."""
    import torch
    dtype, dev = ph.params[0].dtype, ph.params[0].device
    grads = torch.autograd.grad(ph.loss(torch.tensor(0.5, dtype=dtype,
                                                     device=dev)),
                                ph.params)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        ph.count.fill_(MID_COUNT)
        for mu, nu, gr in zip(ph.mu, ph.nu, grads):
            sc = float(gr.abs().max()) or 1.0
            mu.copy_(torch.randn(mu.shape, generator=g).to(dev, dtype)
                     * 0.1 * sc)
            nu.copy_((torch.rand(nu.shape, generator=g).to(dev, dtype)
                      + 0.5) * 0.1 * sc * sc)
