"""The rasterizer's packed compositing route (`composite_packed`): the entry
gather folded into the compositing kernels' staging, and its gradient
into the backward's per-slot store, summed per row by the row-sum kernel
(tests/test_torch_determinism.py). On the CPU the route is the plain chain
``composite_tiles_plain(gather_entries_plain(packed, gidx, k < counts))``;
these tests hold it to the unfused chain and to the JAX package.

  - the fact that makes the fusion exact: the binning's ``ent_valid`` is
    ``arange(K) < counts`` in every slot (fresh bins, training's bins, bins
    whose tiles overflow, bins reused after the means moved);
  - `composite_packed` equals `composite_tiles(gather_entries(...))` on the
    binning's ``ent_valid``, exactly, forward and gradient;
  - `composite_packed_bwd_plain` (the packed CUDA backward's yardstick)
    against autograd through `composite_packed` (1e-6: ``index_add_`` and
    indexing's backward sum the rows in another order) and against JAX's
    ``jax.vjp`` through `_gather_packed` (with its pre-composed bw_idx
    backward) and the reference compositing (each attribute's gradient
    within 2e-3 of JAX's largest, the JAX package's Pallas-versus-reference
    tolerance; the forward to 1e-5), as tests/test_torch_grad.py holds the
    gather and the rasterizer;
  - the packed CUDA wrappers refuse CPU tensors and count no launch.
"""

import importlib

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from starst3r_tpu_torch.config import SplatConfig
from starst3r_tpu_torch.splat import composite as tc
from starst3r_tpu_torch.splat import gather as tg
from starst3r_tpu_torch.splat import train as ttrain

jr = importlib.import_module("starst3r_tpu.splat.rasterize")
tr = importlib.import_module("starst3r_tpu_torch.splat.rasterize")

KW = dict(width=32, height=32, sh_degree=1, tile_size=16,
          max_tiles_per_gaussian=9, max_per_tile=128)
KW_MULTI = dict(width=32, height=32, sh_degree=1, tile_size=16,
                max_tiles_per_gaussian=4, max_per_tile=512)
# 1400 Gaussians pile up to ~400 entries in a tile: 64 slots overflow
KW_CAPPED = dict(KW_MULTI, max_per_tile=64)
# two 128-entry batches in the fullest tiles, at half the JAX compile time
KW_JAX = dict(KW_MULTI, max_per_tile=256)
SCALED_TOL = 2e-3


def _scene(seed=0, n=96):
    """tests/test_pallas_composite.py::_scene as numpy."""
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    means[:, 2] += 2.5
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = rng.uniform(0.01, 0.08, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    sh = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.3
    w2c = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    w2c[1, 0, 3] = 0.15
    K = np.tile(np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]],
                         np.float32)[None], (2, 1, 1))
    return means, quats, scales, opac, sh, w2c, K


def _moved(args, seed=3):
    """The scene with its means moved by a training step's worth of noise
    (bins made before the move are reused after it)."""
    rng = np.random.default_rng(seed)
    means = args[0] + rng.normal(size=args[0].shape).astype(np.float32) * 0.02
    return (means,) + tuple(args[1:])


def _training_bins():
    """train.compute_bins on a state made by init_gaussians (inactive pool
    slots at opacity 0)."""
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(300, 3)).astype(np.float32) * 0.4
    pts[:, 2] += 2.5
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    cfg = SplatConfig(max_per_tile=128, max_tiles_per_gaussian=9)
    state = ttrain.init_gaussians(pts, cols, cfg, pool_size=400,
                                  device="cpu")
    _, _, _, _, _, w2c, K = _scene()
    return ttrain.compute_bins(state.params, torch.from_numpy(w2c),
                               torch.from_numpy(K), 32, 32, cfg,
                               n_alive=state.n_alive)


def _bins(case):
    if case == "train":
        return _training_bins()
    kw = {"scene": KW, "multichunk": KW_MULTI, "capped": KW_CAPPED,
          "moved": KW_MULTI}[case]
    args = _scene(n=96 if case == "scene" else 1400)
    if case == "moved":
        args = _moved(args)
    return tr.bin_gaussians(*[torch.from_numpy(a) for a in args], **kw)


@pytest.mark.parametrize("case", ["scene", "multichunk", "capped", "train",
                                  "moved"])
def test_ent_valid_is_slot_below_count(case):
    """ent_valid[c, t, k] == (k < counts[c, t]) in every slot, so a kernel
    that reads the slots below the count sees exactly the gathered
    entries."""
    bins = _bins(case)
    assert torch.equal(tc.slot_valid(bins.gidx, bins.counts), bins.ent_valid)
    assert int(bins.counts.max()) > 0
    if case == "capped":
        assert int(bins.overflow.sum()) > 0
        assert int(bins.counts.max()) == bins.gidx.shape[-1]


def _render_inputs(args, kw, bins=None):
    """packed, gidx, ent_valid and counts of the scene, as rasterize makes
    them."""
    t_args = [torch.from_numpy(a) for a in args]
    packed, gidx, valid, counts, _ = tr._project_and_bin(
        *t_args, kw["width"], kw["height"], kw["sh_degree"], kw["tile_size"],
        kw["max_tiles_per_gaussian"], kw["max_per_tile"], bins)
    return packed.detach(), gidx, valid, counts


@pytest.fixture
def deterministic():
    """Indexing's backward on the CPU adds rows in parallel, in no fixed
    order, unless torch is asked for its deterministic algorithms."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("case", ["scene", "multichunk", "reused_bins"])
def test_composite_packed_cpu_equals_gather_then_composite(case,
                                                           deterministic):
    """Forward and gradient with respect to packed, exactly: the CPU route
    runs the same operations as the unfused chain on the binning's
    ent_valid (with torch's deterministic algorithms, so the gather's
    backward adds in one order). ``reused_bins``: bins made before the
    means moved."""
    kw = KW if case == "scene" else KW_MULTI
    args = _scene(n=96 if case == "scene" else 1400)
    bins = None
    if case == "reused_bins":
        bins = tr.bin_gaussians(*[torch.from_numpy(a) for a in args], **kw)
        args = _moved(args)
    packed, gidx, valid, counts = _render_inputs(args, kw, bins)
    tw = th = 2
    rng = np.random.default_rng(7)
    g_rgb = torch.from_numpy(rng.normal(size=(2, 32, 32, 3)).astype(
        np.float32))
    g_alpha = torch.from_numpy(rng.normal(size=(2, 32, 32)).astype(
        np.float32))
    out = {}
    for route in ("packed", "unfused"):
        p = packed.clone().requires_grad_(True)
        if route == "packed":
            rgb, alpha = tc.composite_packed(p, gidx, counts, 32, 32, 16, tw,
                                             th)
        else:
            rgb, alpha = tc.composite_tiles(
                tg.gather_entries(p, gidx, valid), counts, 32, 32, 16, tw,
                th)
        (grad,) = torch.autograd.grad((rgb, alpha), p, (g_rgb, g_alpha))
        out[route] = (rgb.detach(), alpha.detach(), grad)
    for name, a, b in zip(("rgb", "alpha", "grad"), out["packed"],
                          out["unfused"]):
        assert torch.equal(a, b), name
    assert float(out["packed"][2].abs().max()) > 0


def _jax_vjp(packed, args, kw, g_rgb, g_alpha):
    """JAX's forward and d(rgb, alpha)/d(packed): `_gather_packed` with its
    bw_idx backward, then the reference compositing per camera."""
    n = args[0].shape[0]
    jb = jr.bin_gaussians(*[jnp.asarray(a) for a in args], **kw)
    gidx_g, ent_valid, bw_g = jr._globalize_bins(
        jb.gidx, jb.ent_valid, jb.bw_idx, n, kw["max_per_tile"])
    k = kw["max_per_tile"]

    def f(p):
        ga = jr._gather_packed(p, gidx_g, ent_valid, bw_g)
        return jax.vmap(lambda e: jr._composite_tiles(
            e[..., 0:2], e[..., 2:5], e[..., 5:8], e[..., 8], 32, 32, 16, 2,
            2, k, 128))(ga)

    (rgb, alpha), vjp = jax.vjp(f, jnp.asarray(packed))
    (d,) = vjp((jnp.asarray(g_rgb), jnp.asarray(g_alpha)))
    return np.asarray(rgb), np.asarray(alpha), np.asarray(d)


def test_composite_packed_bwd_plain_matches_autograd_and_jax():
    """The yardstick of the packed CUDA backward: with every batch
    processed it is the gradient autograd takes through the CPU route, and
    JAX's through its gather and reference compositing."""
    args = _scene(n=1400)
    packed, gidx, _, counts = _render_inputs(args, KW_JAX)
    rng = np.random.default_rng(8)
    g_rgb = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    g_alpha = rng.normal(size=(2, 32, 32)).astype(np.float32)
    done = ((counts.reshape(-1) + tc.BATCH - 1) // tc.BATCH).to(torch.int32)
    assert int(done.max()) > 1                      # several batches
    got = tc.composite_packed_bwd_plain(
        packed, gidx, counts, done, torch.from_numpy(g_rgb),
        torch.from_numpy(g_alpha), 32, 32, 16, 2, 2)
    p = packed.clone().requires_grad_(True)
    rgb, alpha = tc.composite_packed(p, gidx, counts, 32, 32, 16, 2, 2)
    (want,) = torch.autograd.grad((rgb, alpha), p, (torch.from_numpy(g_rgb),
                                                    torch.from_numpy(
                                                        g_alpha)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-6)
    rgb_j, alpha_j, d_j = _jax_vjp(packed.numpy(), args, KW_JAX, g_rgb,
                                   g_alpha)
    np.testing.assert_allclose(rgb.detach().numpy(), rgb_j, atol=1e-5)
    np.testing.assert_allclose(alpha.detach().numpy(), alpha_j, atol=1e-5)
    for a in range(9):
        scale = max(float(np.abs(d_j[:, a]).max()), 1e-6)
        np.testing.assert_allclose(got.numpy()[:, a] / scale,
                                   d_j[:, a] / scale, atol=SCALED_TOL,
                                   err_msg=f"attribute {a}")
    assert float(np.abs(d_j).max()) > 0


def test_packed_cuda_wrappers_refuse_cpu_tensors():
    packed = torch.zeros((10, 9))
    gidx = torch.zeros((1, 4, 8), dtype=torch.int32)
    counts = torch.zeros((1, 4), dtype=torch.int32)
    before = (tc.composite_packed_cuda.launches,
              tc.composite_packed_slots_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tc.composite_packed_cuda(packed, gidx, counts, 32, 32, 16, 2, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tc.composite_packed_bwd_cuda(
            packed, gidx, counts, torch.zeros((1, 32, 32, 3)),
            torch.ones((4, 256)), torch.ones((4,), dtype=torch.int32),
            torch.zeros((1, 32, 32, 3)), torch.zeros((1, 32, 32)), 32, 32,
            16, 2, 2)
    rgb, alpha = tc.composite_packed(packed, gidx, counts, 32, 32, 16, 2, 2)
    assert rgb.shape == (1, 32, 32, 3) and float(alpha.abs().max()) == 0.0
    assert (tc.composite_packed_cuda.launches,
            tc.composite_packed_slots_cuda.launches) == before
