"""The port's 3DGS training against the JAX package's: Adam, SSIM/PSNR,
the MCMC math, `train_step`, `run_optim`, the conversion of a JAX training
state, and the end-to-end image-quality gate.

Inputs are made with numpy from a seed and handed to both packages; where
the JAX package draws random numbers (the MCMC targets and noise), the
test draws them with JAX and feeds the same numbers to the port, whose math
functions take them as arguments. On the CPU the port composites with its
plain version, differentiated by autograd; JAX uses its default CPU path
(the hand-derived reverse sweep).

Stated tolerances:
  - Adam against optax.adam with per-key learning rates: 1e-6 (float32
    rounding of the same operations; the bias correction is taken in
    float32 on both sides);
  - SSIM and PSNR values 1e-5, SSIM gradients 1e-5 absolute (convolutions
    summed in another order);
  - relocation and position noise fed JAX's draws: 1e-5 (float32 pow);
  - `train_step` after 1 and 5 steps: losses to 1e-5 relative, parameters
    to 1e-5 absolute (lr 1e-3: Adam's normalised step would turn a
    gradient that differs in sign into a 1e-3 move); the same for the step
    over Gaussians whose projection overflows, whose means and quats must
    not move at all;
  - `run_optim`, 8 steps with rebin_every=4 and the auto-budget: losses to
    1e-4 relative, means to 1e-4 absolute, the same tile budgets;
  - the e2e gate (port GA + port 3DGS at 64 px, 100 steps) holds the JAX
    test's own bars: held-out PSNR 2 dB above the initial render and above
    13 dB.
"""

import dataclasses
import importlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from starst3r_tpu.config import SplatConfig
from starst3r_tpu.splat import mcmc as jmcmc
from starst3r_tpu.splat import train as jtrain

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.config import SplatConfig as TSplatConfig
from starst3r_tpu_torch.io.from_jax import gs_state_from_jax
from starst3r_tpu_torch.splat import mcmc as tmcmc
from starst3r_tpu_torch.splat import train as ttrain

# the `ops` packages export functions named `ssim`, which shadow the
# modules of that name
jssim = importlib.import_module("starst3r_tpu.ops.ssim")
# and `splat` exports a function named `rasterize`
jrast = importlib.import_module("starst3r_tpu.splat.rasterize")
tssim = importlib.import_module("starst3r_tpu_torch.ops.ssim")

torch.backends.cudnn.allow_tf32 = False

KEYS = ("means", "scales", "quats", "opacities", "sh0", "shN")
E2E_STEPS = 100


def _np(x):
    return np.array(jax.device_get(x))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _fit_problem(seed=0, n=512, c=2):
    """tests/test_splat.py::test_train_step_stays_finite's problem."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    gt = rng.uniform(size=(c, 32, 32, 3)).astype(np.float32)
    w2c = np.tile(np.eye(4, dtype=np.float32)[None], (c, 1, 1))
    K = np.tile(np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]],
                         np.float32)[None], (c, 1, 1))
    return pts, cols, gt, w2c, K


def _params(seed, n=256):
    rng = np.random.default_rng(seed)
    return {
        "means": rng.normal(size=(n, 3)).astype(np.float32),
        "scales": rng.uniform(0.005, 0.05, size=(n, 3)).astype(np.float32),
        "quats": rng.normal(size=(n, 4)).astype(np.float32),
        "opacities": rng.uniform(0.0, 1.0, size=(n,)).astype(np.float32),
        "sh0": rng.normal(size=(n, 1, 3)).astype(np.float32),
        "shN": rng.normal(size=(n, 24, 3)).astype(np.float32),
    }


def _assert_params(tp, jp, atol, keys=KEYS):
    for k in keys:
        np.testing.assert_allclose(tp[k].numpy(), _np(jp[k]), atol=atol,
                                   rtol=0, err_msg=k)


def test_adam_matches_optax_with_per_key_lrs():
    cfg_kw = dict(lr=1e-3, lr_means=2e-4, lr_opacities=5e-2, lr_sh=2.5e-3)
    jcfg, tcfg = SplatConfig(**cfg_kw), TSplatConfig(**cfg_kw)
    params = _params(0)
    opt = jtrain.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    tp = {k: _t(v) for k, v in params.items()}
    ts = ttrain.adam_init(tp)
    rng = np.random.default_rng(1)
    for _ in range(4):
        g = {k: rng.normal(size=v.shape).astype(np.float32) * 0.1
             for k, v in params.items()}
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = ttrain.adam_update({k: _t(v) for k, v in g.items()}, ts,
                                    tp, tcfg)
    _assert_params(tp, jp, 1e-6)
    assert ts.count == int(js[0].count) == 4
    for k in KEYS:
        np.testing.assert_allclose(ts.mu[k].numpy(), _np(js[0].mu[k]),
                                   atol=1e-7)
        np.testing.assert_allclose(ts.nu[k].numpy(), _np(js[0].nu[k]),
                                   atol=1e-7)


def test_ssim_psnr_and_grads_match_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(size=(2, 24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    np.testing.assert_allclose(float(tssim.ssim(_t(a), _t(b))),
                               float(jssim.ssim(a, b)), atol=1e-5)
    np.testing.assert_allclose(float(tssim.ssim(_t(a[0]), _t(b[0]))),
                               float(jssim.ssim(a[0], b[0])), atol=1e-5)
    per = tssim.ssim_per_image(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(per, [float(jssim.ssim(a[i], b[i]))
                                     for i in range(2)], atol=1e-5)
    np.testing.assert_allclose(float(tssim.psnr(_t(a), _t(b))),
                               float(jssim.psnr(a, b)), rtol=1e-5)
    g_j = _np(jax.grad(lambda y: jssim.ssim(jnp.asarray(a), y))(
        jnp.asarray(b)))
    bt = _t(b).requires_grad_(True)
    (g_t,) = torch.autograd.grad(tssim.ssim(_t(a), bt), bt)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-5)


@pytest.mark.parametrize("compat", [True, False])
def test_relocate_dead_matches_jax_fed_its_targets(compat):
    """Growth plus dead-slot relocation, fed the targets JAX's own
    categorical draw gives for the same key."""
    cfg = SplatConfig(compat_raw_activations=compat)
    tcfg = TSplatConfig(compat_raw_activations=compat)
    params = _params(4)
    if not compat:
        params["opacities"] = np.log(params["scales"][:, 0] * 10)
        params["scales"] = np.log(params["scales"])
    params["opacities"][:40] = -8.0 if not compat else 0.001   # dead
    n_alive, n_target = 200, 230
    key = jax.random.PRNGKey(7)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    j_out, j_rel = jmcmc.relocate_dead(
        key, jp, jtrain._opacity_act(cfg), jtrain._scale_act(cfg),
        min_opacity=0.005, n_alive=jnp.asarray(n_alive),
        n_target=jnp.asarray(n_target))
    # the draw relocate_dead makes inside, repeated with its key
    op = jnp.clip(jtrain._opacity_act(cfg)[0](jp["opacities"]), 1e-6,
                  1 - 1e-6)
    idx = jnp.arange(op.shape[0])
    dead = (((idx < n_alive) & (op <= 0.005))
            | ((idx >= n_alive) & (idx < n_target)))
    live = (idx < n_alive) & ~dead
    targets = _np(jmcmc._sample_alive(key, op, live, op.shape[0]))
    t_out, t_rel = tmcmc.relocate_dead(
        {k: _t(v) for k, v in params.items()}, ttrain._opacity_act(tcfg),
        ttrain._scale_act(tcfg), min_opacity=0.005, n_alive=n_alive,
        n_target=n_target, targets=torch.from_numpy(targets.astype(np.int64)))
    np.testing.assert_array_equal(t_rel.numpy(), _np(j_rel))
    assert bool(t_rel[:40].all()) and bool(t_rel[n_alive:n_target].all())
    _assert_params(t_out, j_out, 1e-5)


def test_add_position_noise_matches_jax_fed_its_eps():
    params = _params(5)
    key = jax.random.PRNGKey(3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    j_out = jmcmc.add_position_noise(key, jp, 1e-3, 5e5,
                                     n_alive=jnp.asarray(200))
    eps = _np(jax.random.normal(key, params["means"].shape))
    t_out = tmcmc.add_position_noise({k: _t(v) for k, v in params.items()},
                                     1e-3, 5e5, n_alive=200, eps=_t(eps))
    _assert_params(t_out, j_out, 1e-5)
    assert float(np.abs(t_out["means"].numpy()[200:]
                        - params["means"][200:]).max()) == 0.0


def test_grow_target_is_float32_as_jax():
    mcfg = jmcmc.MCMCConfig(cap_max=10 ** 7)
    tcfg = tmcmc.MCMCConfig(cap_max=10 ** 7)
    # 60, 100, 120, ...: n * 1.05 is a whole number that float32 misses
    ns = [0, 1, 19, 20, 60, 100, 120, 128, 300_266, 315_279, 331_042,
          999_999, 2_345_679]
    ns += list(range(1_000_000, 1_000_400))
    want = [int(jmcmc.grow_target(jnp.asarray(n, jnp.int32), 10 ** 8, mcfg))
            for n in ns]
    got = [tmcmc.grow_target(n, 10 ** 8, tcfg) for n in ns]
    assert got == want
    # float64 gives other counts for some of them: the float32 matters
    assert any(int(np.floor(n * 1.05)) != w for n, w in zip(ns, want))
    assert tmcmc.grow_target(100, 103, tcfg) == 103          # capped


def test_mcmc_relocate_invariants():
    """tests/test_splat.py::test_mcmc_relocate_invariants on the port,
    with the port's own sampler."""
    rng = np.random.default_rng(0)
    n = 256
    params = {
        "means": _t(rng.normal(size=(n, 3))),
        "scales": torch.full((n, 3), 0.01),
        "quats": torch.tensor([1.0, 0, 0, 0]).repeat(n, 1),
        "opacities": _t(rng.uniform(0.5, 1.2, size=(n,))),
        "sh0": torch.zeros((n, 1, 3)),
        "shN": torch.zeros((n, 24, 3)),
    }
    params["opacities"][:50] = 0.001
    gen = torch.Generator().manual_seed(0)
    out, relocated = tmcmc.relocate_dead(params, generator=gen)
    assert out["means"].shape == (n, 3)
    assert bool(torch.isfinite(out["opacities"]).all())
    assert bool(relocated[:50].all())
    moved = out["means"][:50].numpy()
    live = params["means"][50:].numpy()
    d = np.min(np.linalg.norm(moved[:, None] - live[None], axis=-1), 1)
    assert np.all(d < 1e-6)


def test_mcmc_noise_scales_with_opacity():
    n = 128
    params = {
        "means": torch.zeros((n, 3)),
        "scales": torch.full((n, 3), 0.01),
        "quats": torch.tensor([1.0, 0, 0, 0]).repeat(n, 1),
        "opacities": torch.cat([torch.full((n // 2,), 0.001),
                                torch.full((n // 2,), 1.0)]),
        "sh0": torch.zeros((n, 1, 3)),
        "shN": torch.zeros((n, 24, 3)),
    }
    out = tmcmc.add_position_noise(params, lr=1e-3,
                                   generator=torch.Generator().manual_seed(0))
    move = out["means"].norm(dim=-1).numpy()
    assert move[: n // 2].mean() > 100 * max(move[n // 2:].mean(), 1e-12)


@pytest.mark.parametrize("steps", [1, 5])
def test_train_step_matches_jax(steps):
    pts, cols, gt, w2c, K = _fit_problem()
    jcfg, tcfg = SplatConfig(), TSplatConfig()
    js = jtrain.init_gaussians(pts, cols, jcfg)
    ts = ttrain.init_gaussians(pts, cols, tcfg, device="cpu")
    jl, tl = [], []
    for _ in range(steps):
        js, loss = jtrain.train_step(js, jnp.asarray(gt), jnp.asarray(w2c),
                                     jnp.asarray(K), 32, 32, jcfg, 2)
        jl.append(float(loss))
        ts, loss = ttrain.train_step(ts, _t(gt), _t(w2c), _t(K), 32, 32,
                                     tcfg, 2)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_params(ts.params, js.params, 1e-5)
    assert ts.step == int(js.step) == steps
    assert ts.opt_state.count == int(js.opt_state[0].count)
    if steps == 5:
        assert tl[-1] < tl[0]


def test_run_optim_rebin_and_autobudget_match_jax():
    """8 steps, rebin_every=4, the auto-budget on (no pruning): the same
    losses, means and tile budgets as the JAX loop."""
    pts, cols, gt, w2c, K = _fit_problem(seed=1, n=256)
    jcfg, tcfg = SplatConfig(rebin_every=4), TSplatConfig(rebin_every=4)
    js, jl = jtrain.run_optim(jtrain.init_gaussians(pts, cols, jcfg), gt,
                              w2c, K, 8, jcfg)
    ts0 = ttrain.init_gaussians(pts, cols, tcfg, device="cpu")
    ts, tl = ttrain.run_optim(ts0, gt, w2c, K, 8, tcfg)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    _assert_params(ts.params, js.params, 1e-4, keys=("means",))
    jb = jtrain._autobudget_cfg(jtrain.init_gaussians(pts, cols, jcfg),
                                jnp.asarray(w2c), jnp.asarray(K), 32, 32,
                                jcfg)
    tb = ttrain._autobudget_cfg(ts0, _t(w2c), _t(K), 32, 32, tcfg)
    assert (tb.max_tiles_per_gaussian, tb.max_per_tile) == (
        jb.max_tiles_per_gaussian, jb.max_per_tile)
    assert tb.max_per_tile < tcfg.max_per_tile     # the budget did shrink
    assert ts.step == 8 and ts0.step == 0          # the step is functional


def test_mcmc_growth_reaches_cap():
    """tests/test_splat.py::test_mcmc_growth_reaches_cap on the port."""
    pts, cols, gt, w2c, K = _fit_problem(n=128)
    cfg = dataclasses.replace(TSplatConfig(), cap_max=256,
                              mcmc_refine_start=1, mcmc_refine_every=2,
                              mcmc_grow_factor=1.5)
    state = ttrain.init_gaussians(pts, cols, cfg, pool_size=256,
                                  device="cpu")
    assert state.n_alive == 128
    state, losses = ttrain.run_optim(state, gt, w2c, K, 8, cfg,
                                     enable_pruning=True)
    assert state.n_alive == 256
    assert state.params["means"].shape == (256, 3)
    assert all(np.isfinite(losses))
    moved = state.params["means"][128:].numpy()
    assert np.all(np.isfinite(moved)) and float(np.abs(moved).sum()) > 0.0


def test_scene_run_3dgs_optim_grows_by_default():
    """The product path, Scene.init_3dgs -> Scene.run_3dgs_optim
    (tests/test_splat.py::test_scene_init_3dgs_growth_active_by_default):
    the default pool headroom makes growth active, n_alive follows
    grow_target at every refine, and the trained render differs."""
    rng = np.random.default_rng(0)
    n = 128
    cfg = stt.default_config()
    cfg = dataclasses.replace(cfg, splat=dataclasses.replace(
        cfg.splat, mcmc_refine_start=1, mcmc_refine_every=2,
        mcmc_grow_factor=1.5))
    scene = stt.Scene(config=cfg, device="cpu")
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    scene.dense_pts = [pts]
    scene.dense_cols = [rng.uniform(size=(n, 3)).astype(np.float32)]
    scene.c2w = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    scene.intrinsics = np.tile(
        np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]],
                 np.float32)[None], (2, 1, 1))
    scene.imgs = [rng.uniform(size=(32, 32, 3)).astype(np.float32)
                  for _ in range(2)]
    state = scene.init_3dgs()
    assert state.params["means"].shape[0] == int(cfg.splat.pool_headroom * n)
    before = scene.render_3dgs_original(32, 32)[0]
    losses = scene.run_3dgs_optim(6, enable_pruning=True)
    assert len(losses) == 6 and all(np.isfinite(losses))
    mcfg = ttrain.mcmc_config_from(cfg.splat)
    want = n
    for _ in range(3):
        want = tmcmc.grow_target(want, 2 * n, mcfg)
    assert scene.gs_state.n_alive == want > n
    after = scene.render_3dgs_original(32, 32)[0]
    assert bool(torch.isfinite(after).all())
    assert float((after - before).abs().max()) > 0


def test_gs_state_from_jax_then_one_step():
    """A JAX state after 3 steps, carried into the port: one more step on
    each side agrees."""
    pts, cols, gt, w2c, K = _fit_problem(seed=2, n=256)
    cfg_kw = dict(lr_means=5e-4, lr_opacities=5e-2)
    jcfg, tcfg = SplatConfig(**cfg_kw), TSplatConfig(**cfg_kw)
    js = jtrain.init_gaussians(pts, cols, jcfg, pool_size=300)
    args = (jnp.asarray(gt), jnp.asarray(w2c), jnp.asarray(K), 32, 32, jcfg,
            2)
    for _ in range(3):
        js, _ = jtrain.train_step(js, *args)
    ts = gs_state_from_jax(jax.device_get(js), device="cpu")
    assert ts.step == 3 and ts.opt_state.count == 3 and ts.n_alive == 256
    _assert_params(ts.opt_state.nu, js.opt_state[0].nu, 0.0)
    js, jl = jtrain.train_step(js, *args)
    ts, tl = ttrain.train_step(ts, _t(gt), _t(w2c), _t(K), 32, 32, tcfg, 2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params(ts.params, js.params, 1e-5)


def test_non_finite_gradient_elements_get_no_update():
    """Gaussians whose projection overflows get no update from the image,
    as in the JAX step. Far off axis at the world box's edge, behind the
    camera's plane and wide, their a*c and b*b overflow and det = inf - inf
    is NaN: the pair is invalid on both sides. The JAX package's compiled
    step passes them no gradient. An eager backward turns their zero
    cotangent into NaN at a NaN divisor (0 * NaN), which Adam would write
    into their parameters, so the port's projection divides such pairs by
    1: every gradient is finite, their means and quats stay as they were,
    and the step is JAX's."""
    pts, cols, gt, w2c, K = _fit_problem(n=64)
    far = np.array([[1e16, 1e16, -1e16], [-1e16, 1e16, -1e16],
                    [1e16, -1e16, -1e16], [-2e5, 3e5, 0.005]], np.float32)
    pts = np.concatenate([pts, far])
    cols = np.concatenate([cols, np.full((4, 3), 0.5, np.float32)])
    scales = np.full(68, 0.003, np.float32)
    scales[64:] = 0.3
    cfg = dict(max_per_tile=128)
    js = jtrain.init_gaussians(pts, cols, SplatConfig(**cfg),
                               point_scales=scales)
    jp = js.params
    proj = jrast.project_gaussians(jp["means"], jp["quats"], jp["scales"],
                                   jp["opacities"], jp["shN"],
                                   jnp.asarray(w2c[0]), jnp.asarray(K[0]))
    assert not np.isfinite(_np(proj.conics)[64:]).any()
    assert not _np(proj.valid)[64:].any()
    js, jl = jtrain.train_step(js, jnp.asarray(gt), jnp.asarray(w2c),
                               jnp.asarray(K), 32, 32, SplatConfig(**cfg), 2)
    ts0 = ttrain.init_gaussians(pts, cols, TSplatConfig(**cfg),
                                point_scales=scales, device="cpu")
    ts, tl = ttrain.train_step(ts0, _t(gt), _t(w2c), _t(K), 32, 32,
                               TSplatConfig(**cfg), 2)
    for k in KEYS:
        assert bool(torch.isfinite(ts.opt_state.mu[k]).all()), k
        assert bool(torch.isfinite(ts.params[k]).all()), k
    for k in ("means", "quats"):
        np.testing.assert_array_equal(ts.params[k][64:].numpy(),
                                      ts0.params[k][64:].numpy())
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params(ts.params, js.params, 1e-5)


def test_reference_faults_are_reproduced(monkeypatch):
    """Two faults of the reference the port keeps (ROADMAP queue 3):
    a non-positive point scale gives NaN under the fixed activations
    (starst3r_tpu/splat/train.py:127), and every refine moves the drift
    anchors of every Gaussian, not only the relocated ones
    (starst3r_tpu/splat/train.py:476)."""
    pts, cols, gt, w2c, K = _fit_problem(n=64)
    scales = np.full(64, 0.01, np.float32)
    scales[3] = 0.0
    fixed = dict(compat_raw_activations=False)
    js = jtrain.init_gaussians(pts, cols, SplatConfig(**fixed),
                               point_scales=scales)
    ts = ttrain.init_gaussians(pts, cols, TSplatConfig(**fixed),
                               point_scales=scales, device="cpu")
    assert not np.isfinite(_np(js.params["scales"])[3]).all()
    assert not bool(torch.isfinite(ts.params["scales"][3]).all())

    seen = []
    real_step = ttrain.train_step

    def spy(state, *a, anchors=None, **kw):
        seen.append((anchors.clone(), state.params["means"].clone()))
        return real_step(state, *a, anchors=anchors, **kw)

    monkeypatch.setattr(ttrain, "train_step", spy)
    cfg = TSplatConfig(loss_anchor_fac=1.0, mcmc_refine_start=2,
                       mcmc_refine_every=2, cap_max=80)
    state = ttrain.init_gaussians(pts, cols, cfg, pool_size=80, device="cpu")
    ttrain.run_optim(state, gt, w2c, K, 3, cfg, enable_pruning=True)
    # step 3 runs after the refine at step 2: its anchors are all the
    # means as they were, those of untouched Gaussians included
    anchors, means = seen[2]
    np.testing.assert_array_equal(anchors.numpy(), means.numpy())
    assert float((anchors - seen[0][0]).abs()[:64].max()) > 0


def test_e2e_image_quality_gate():
    """tests/test_integration.py::test_e2e_image_quality_gate on the port:
    the port's GA on the JAX package's planted image scene (exact
    synthetic data, 64 px), then the port's 3DGS trained on the recovered
    poses; the held-out view's PSNR must clearly beat the initial
    render. The port's plain compositing on the CPU is eager torch, so the
    loop runs E2E_STEPS = 100 steps (the JAX test runs 200) to keep this
    file within its time; the bars are the JAX test's."""
    from starst3r_tpu.utils.synthetic import synthetic_image_scene

    from starst3r_tpu_torch.alignment.condense import CondensedData
    from starst3r_tpu_torch.alignment.ga import run_global_alignment
    from starst3r_tpu_torch.config import GAConfig

    data, mst, _gt, _K, imgs, hit = synthetic_image_scene(
        n_cams=5, hw=64, subsample=4, focal=90.0)
    res, _ = run_global_alignment(
        CondensedData(**data._asdict()), mst,
        GAConfig(niter1=300, niter2=100, lr2=0.004), device="cpu")
    hold = 2
    tc = [i for i in range(5) if i != hold]
    cp = np.asarray(data.core_pix).astype(np.int64)
    m = hit[tc].reshape(-1)
    pts = res.pts3d.numpy()[tc].reshape(-1, 3)[m]
    cols = np.stack([imgs[i][cp[:, 1], cp[:, 0]]
                     for i in tc]).reshape(-1, 3)[m]
    scales = (res.depth.numpy()[tc].reshape(-1)[m] * 4
              / res.K.numpy()[tc, 0, 0].repeat(data.core_pix.shape[0])[m])
    cfg = dataclasses.replace(
        TSplatConfig(rebin_every=4), pool_headroom=0.0,
        compat_inverted_sh=False, compat_raw_activations=False,
        lr_means=5e-4, lr_quats=1e-3, lr_scales=5e-3, lr_opacities=5e-2,
        lr_sh=2.5e-3)
    state = ttrain.init_gaussians(pts, cols, cfg, point_scales=scales,
                                  device="cpu")
    w2c = res.w2c.numpy()
    Ks = res.K.numpy()
    target = _t(imgs[hold])

    def held_out_psnr(st):
        rgb = ttrain.render(st.params, w2c[hold:hold + 1], Ks[hold:hold + 1],
                            64, 64, cfg, n_alive=st.n_alive)[0][0]
        return float(tssim.psnr(target, torch.clamp(rgb, 0, 1)))

    p0 = held_out_psnr(state)
    state, losses = ttrain.run_optim(state, imgs[tc], w2c[tc], Ks[tc],
                                     E2E_STEPS, cfg)
    p1 = held_out_psnr(state)
    assert losses[-1] < losses[0]
    assert p1 > p0 + 2.0, (p0, p1)
    assert p1 > 13.0, p1
    print(f"e2e held-out PSNR {p0:.2f} -> {p1:.2f} dB")
