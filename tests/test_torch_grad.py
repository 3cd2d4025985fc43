"""Gradients of the port's rasterizer against the JAX package's.

On the CPU the port differentiates its plain versions with autograd: the
compositing (`composite_tiles_plain`) and the entry gather
(`packed[gidx] * ent_valid`). They are held against

  - JAX `rasterize(impl="ref")` (autodiff through the reference scan) and
    `impl="pallas"` (the Pallas forward and backward kernels, run in
    interpret mode as the JAX package's own tests run them) on the scene of
    tests/test_pallas_composite.py;
  - JAX `impl="xla"` (the hand-derived reverse sweep) on its 1400-Gaussian
    scene with several 128-entry batches per tile;
  - JAX `impl="ref"` on the opaque wall, where JAX's own reverse sweeps
    return zero gradients (a reference fault the test names);
  - the Pallas backward kernel itself (`_bwd_rule`), against
    `composite_tiles_bwd_plain`, the yardstick of the port's CUDA backward;
  - the JAX gather with its pre-composed backward (`_gather_packed`),
    against the port's gather.

Tolerance: each gradient divided by the largest magnitude of its JAX
counterpart agrees to 2e-3, the JAX package's own Pallas-versus-reference
tolerance (tests/test_pallas_composite.py). Forward values agree to 1e-5
(1e-4 against the Pallas forward, its own tolerance). The gather's forward
is exact; its backward sums in another order (1e-6). Reusing the binning
(``bins=``) gives the same values exactly and the same gradients to 1e-5
relative (the gather's backward accumulates in no fixed order).
"""

import importlib

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from starst3r_tpu.splat import pallas_composite as jpc

from starst3r_tpu_torch.splat import composite as tc
from starst3r_tpu_torch.splat import gather as tg

jr = importlib.import_module("starst3r_tpu.splat.rasterize")
tr = importlib.import_module("starst3r_tpu_torch.splat.rasterize")

KW = dict(width=32, height=32, sh_degree=1, tile_size=16,
          max_tiles_per_gaussian=9, max_per_tile=128, chunk=32)
KW_MULTI = dict(width=32, height=32, sh_degree=1, tile_size=16,
                max_tiles_per_gaussian=4, max_per_tile=512, chunk=128)
NAMES = ("means", "quats", "scales", "opac", "sh")
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


def _jax_grads(args, impl, kw, loss_kind):
    cams = (jnp.asarray(args[5]), jnp.asarray(args[6]))
    tgt = jnp.asarray(np.random.default_rng(5).uniform(
        size=(2, 32, 32, 3)).astype(np.float32))

    def loss(*g):
        rgb, alpha, _ = jr.rasterize(*g, *cams, impl=impl, **kw)
        if loss_kind == "mse":
            return jnp.mean((rgb - tgt) ** 2) + 0.1 * jnp.mean(alpha)
        return jnp.sum(rgb * rgb) + jnp.sum(alpha)

    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in args[:5]])
    return [np.asarray(g) for g in grads], np.asarray(tgt)


def _port_grads(args, kw, loss_kind, tgt, bins=None):
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in args[:5]]
    cams = [torch.from_numpy(a) for a in args[5:]]
    rgb, alpha, _ = tr.rasterize(*leaves, *cams, bins=bins, **kw)
    if loss_kind == "mse":
        loss = (torch.mean((rgb - torch.from_numpy(tgt.copy())) ** 2)
                + 0.1 * torch.mean(alpha))
    else:
        loss = torch.sum(rgb * rgb) + torch.sum(alpha)
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)], rgb, alpha


def _assert_scaled(got, want, name):
    assert np.all(np.isfinite(got)), name
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got / scale, want / scale, atol=SCALED_TOL,
                               err_msg=name)


@pytest.mark.parametrize("impl", ["ref", "pallas"])
def test_rasterize_gradients_match_jax(impl):
    """means, quats, scales, opacities and sh gradients of an MSE + alpha
    loss, port (plain autograd) against JAX autodiff and the Pallas
    backward kernel."""
    args = _scene()
    want, tgt = _jax_grads(args, impl, KW, "mse")
    got, _, _ = _port_grads(args, KW, "mse", tgt)
    for name, g, w in zip(NAMES, got, want):
        _assert_scaled(g, w, name)


def _opaque_wall(seed=0, n=600):
    """The opaque wall of tests/test_pallas_composite.py
    (test_pallas_early_exit_opaque_wall), 600 splats deep and coloured."""
    rng = np.random.default_rng(seed)
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = np.linspace(1.0, 5.0, n)
    means[:, :2] = rng.normal(size=(n, 2)) * 0.01
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 2.0, np.float32)
    opac = np.full((n,), 0.999, np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0] = rng.normal(size=(n, 3))
    w2c = np.eye(4, dtype=np.float32)[None]
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)[None]
    return means, quats, scales, opac, sh, w2c, K


def test_opaque_wall_gradients_match_jax_reference():
    """A wall of near-opaque splats drives every pixel's transmittance to
    0 (it underflows) within the tile's first batch. The port's gradients
    match JAX autodiff (`impl="ref"`). JAX's hand-derived backward
    (`impl="xla"`) and its Pallas backward rebuild transmittance by
    dividing the underflowed T_fin, and give all-zero gradients here: a
    fault of the reference, which the port's CUDA backward, walking front
    to back, does not share."""
    args = _opaque_wall()
    cams = (jnp.asarray(args[5]), jnp.asarray(args[6]))
    kw = dict(KW, max_per_tile=1024, chunk=128)

    def jloss(impl, m, s):
        rgb, alpha, _ = jr.rasterize(m, jnp.asarray(args[1]),
                                     jnp.asarray(args[2]),
                                     jnp.asarray(args[3]), s, *cams,
                                     impl=impl, **kw)
        return jnp.sum(rgb * rgb) + jnp.sum(alpha)

    grads = {impl: [np.asarray(g) for g in jax.grad(
        lambda m, s: jloss(impl, m, s), argnums=(0, 1))(
            jnp.asarray(args[0]), jnp.asarray(args[4]))]
        for impl in ("ref", "xla")}
    got, _, _ = _port_grads(args, kw, "sum", None)
    for name, g, w in zip(("means", "sh"), (got[0], got[4]), grads["ref"]):
        assert float(np.abs(w).max()) > 0, name
        _assert_scaled(g, w, name)
    assert all(float(np.abs(g).max()) == 0.0 for g in grads["xla"])


def test_rasterize_gradients_match_jax_multichunk():
    """The 1400-Gaussian scene (up to 512 entries per tile, several
    128-entry batches) against the JAX analytic reverse sweep."""
    args = _scene(n=1400)
    want, tgt = _jax_grads(args, "xla", KW_MULTI, "sum")
    got, _, _ = _port_grads(args, KW_MULTI, "sum", tgt)
    for name, g, w in zip(NAMES, got, want):
        _assert_scaled(g, w, name)


@pytest.mark.parametrize("kw", [KW, KW_MULTI], ids=["scene", "multichunk"])
def test_bins_reuse_matches_fresh_binning(kw):
    """`rasterize(..., bins=bin_gaussians(...))` on the same parameters
    gives the same renders and gradients as binning inside the call."""
    args = _scene(n=96 if kw is KW else 1400)
    tgt = np.zeros((2, 32, 32, 3), np.float32)
    t_args = [torch.from_numpy(a) for a in args]
    bins = tr.bin_gaussians(
        *t_args, kw["width"], kw["height"], kw["sh_degree"],
        kw["tile_size"], kw["max_tiles_per_gaussian"], kw["max_per_tile"])
    assert bins.gidx.dtype == torch.int32 and bins.counts.dtype == torch.int32
    g0, rgb0, a0 = _port_grads(args, kw, "sum", tgt)
    g1, rgb1, a1 = _port_grads(args, kw, "sum", tgt, bins=bins)
    np.testing.assert_array_equal(rgb1.detach().numpy(),
                                  rgb0.detach().numpy())
    np.testing.assert_array_equal(a1.detach().numpy(), a0.detach().numpy())
    # the gather's backward accumulates rows in no fixed order
    for name, x, y in zip(NAMES, g1, g0):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6, err_msg=name)


def test_bin_gaussians_and_max_bbox_area_match_jax():
    args = _scene(n=1400)
    kw = {k: v for k, v in KW_MULTI.items() if k != "chunk"}
    jb = jr.bin_gaussians(*[jnp.asarray(a) for a in args], **kw)
    tb = tr.bin_gaussians(*[torch.from_numpy(a) for a in args], **kw)
    for f in ("ent_valid", "counts", "overflow", "n_clipped", "max_count"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    area_kw = dict(width=32, height=32, tile_size=16)
    assert int(tr.max_bbox_area(*[torch.from_numpy(a) for a in args],
                                **area_kw)) == int(jr.max_bbox_area(
                                    *[jnp.asarray(a) for a in args],
                                    **area_kw))


def _random_entries(seed, c, tw, th, tile, k):
    rng = np.random.default_rng(seed)
    t = tw * th
    ent = np.zeros((c, t, k, 9), np.float32)
    counts = rng.integers(0, k + 1, size=(c, t)).astype(np.int32)
    counts[0, 0] = k
    for ci in range(c):
        for ti in range(t):
            m = counts[ci, ti]
            x0, y0 = (ti % tw) * tile, (ti // tw) * tile
            ent[ci, ti, :m, 0] = rng.uniform(x0 - 4, x0 + tile + 4, m)
            ent[ci, ti, :m, 1] = rng.uniform(y0 - 4, y0 + tile + 4, m)
            ent[ci, ti, :m, 2] = rng.uniform(0.02, 0.3, m)
            ent[ci, ti, :m, 3] = rng.uniform(-0.01, 0.01, m)
            ent[ci, ti, :m, 4] = rng.uniform(0.02, 0.3, m)
            ent[ci, ti, :m, 5:8] = rng.uniform(0, 1, (m, 3))
            ent[ci, ti, :m, 8] = rng.uniform(0.05, 1.0, m)
    return ent, counts


def test_composite_bwd_plain_matches_pallas_bwd_kernel():
    """`composite_tiles_bwd_plain` (the CUDA backward's yardstick) against
    the Pallas `_bwd_kernel` on the same entries, pixel gradients and the
    Pallas forward's own `done`."""
    c, tw, th, tile, k = 2, 2, 2, 16, 256
    h, w = 30, 27                                   # ragged image edge
    ent, counts = _random_entries(4, c, tw, th, tile, k)
    rng = np.random.default_rng(6)
    g_rgb = rng.normal(size=(c, h, w, 3)).astype(np.float32)
    g_alpha = rng.normal(size=(c, h, w)).astype(np.float32)

    e = jnp.asarray(ent)
    split = (e[..., 0:2], e[..., 2:5], e[..., 5:8], e[..., 8])

    def comp(gm, gc, gcol, gop):
        return jpc.composite_tiles_pallas(gm, gc, gcol, gop,
                                          jnp.asarray(counts), h, w, tile,
                                          tw, th, 128)

    _, vjp = jax.vjp(comp, *split)
    d = vjp((jnp.asarray(g_rgb), jnp.asarray(g_alpha)))
    want = np.concatenate([np.asarray(d[0]), np.asarray(d[1]),
                           np.asarray(d[2]), np.asarray(d[3])[..., None]],
                          -1)
    attr = jpc._pack_attr(*[x.reshape((c * tw * th,) + x.shape[2:])
                            for x in split], 128)
    _, _, done = jpc._run_fwd(attr, jnp.asarray(counts).reshape(-1), tile,
                              tw, th, 128)
    got = tc.composite_tiles_bwd_plain(
        torch.from_numpy(ent), torch.from_numpy(counts),
        torch.from_numpy(np.array(done)), torch.from_numpy(g_rgb),
        torch.from_numpy(g_alpha), h, w, tile, tw, th).numpy()
    for a in range(9):
        _assert_scaled(got[..., a], want[..., a], f"attribute {a}")


@pytest.mark.parametrize("case", ["random", "wall"])
def test_done_plain_matches_pallas_fwd_done(case):
    """`done_plain` (what the CUDA forward's early exit is held to) against
    the Pallas `_fwd_kernel`'s own `done`: every batch of random entries,
    and the opaque wall's tiles stopping after their first batch."""
    if case == "random":
        ent, counts = _random_entries(4, 2, 2, 2, 16, 256)
    else:
        args = list(_opaque_wall())
        args[5] = np.tile(args[5], (2, 1, 1))
        args[6] = np.tile(args[6], (2, 1, 1))
        ent_t, cnt_t, _ = tr.tile_entries(*[torch.from_numpy(a)
                                            for a in args], 32, 32, 1, 16,
                                          9, 1024)
        ent, counts = ent_t.numpy(), cnt_t.numpy()
    c, t = counts.shape
    e = jnp.asarray(ent)
    attr = jpc._pack_attr(e[..., 0:2].reshape(c * t, -1, 2),
                          e[..., 2:5].reshape(c * t, -1, 3),
                          e[..., 5:8].reshape(c * t, -1, 3),
                          e[..., 8].reshape(c * t, -1), 128)
    _, _, want = jpc._run_fwd(attr, jnp.asarray(counts).reshape(-1), 16, 2,
                              2, 128)
    got, near = tc.done_plain(torch.from_numpy(ent),
                              torch.from_numpy(counts), 16, 2, 2)
    assert not bool(near.any())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    batches = (counts.reshape(-1) + 127) // 128
    if case == "wall":
        assert bool((got.numpy() == 1).all()) and int(batches.min()) > 1
    else:
        np.testing.assert_array_equal(got.numpy(), batches)


def test_composite_tiles_cpu_is_differentiable_plain():
    """On the CPU `composite_tiles` is the plain version, and autograd
    through it gives `composite_tiles_bwd_plain` where every batch ran."""
    c, tw, th, tile, k = 1, 2, 1, 8, 40
    ent, counts = _random_entries(7, c, tw, th, tile, k)
    e = torch.from_numpy(ent).requires_grad_(True)
    rgb, alpha = tc.composite_tiles(e, torch.from_numpy(counts), 8, 16,
                                    tile, tw, th, chunk=16)
    g_rgb, g_alpha = torch.ones_like(rgb), torch.ones_like(alpha)
    (grad,) = torch.autograd.grad((rgb, alpha), e, (g_rgb, g_alpha))
    done = torch.full((c * tw * th,), 1, dtype=torch.int32)
    plain = tc.composite_tiles_bwd_plain(e, torch.from_numpy(counts), done,
                                         g_rgb, g_alpha, 8, 16, tile, tw, th,
                                         chunk=16)
    np.testing.assert_allclose(plain.numpy(), grad.numpy(), atol=1e-6)


def test_gather_matches_jax_gather_packed():
    """The entry gather and its backward (an index_add) against the JAX
    package's `_gather_packed` with its pre-composed bw_idx backward."""
    args = _scene(n=1400)
    kw = {k: v for k, v in KW_MULTI.items() if k != "chunk"}
    n = args[0].shape[0]
    jb = jr.bin_gaussians(*[jnp.asarray(a) for a in args], **kw)
    gidx_g, ent_valid, bw_g = jr._globalize_bins(
        jb.gidx, jb.ent_valid, jb.bw_idx, n, kw["max_per_tile"])
    rng = np.random.default_rng(2)
    packed = rng.normal(size=(2 * n, 9)).astype(np.float32)
    cot = rng.normal(size=tuple(gidx_g.shape) + (9,)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda p: jr._gather_packed(p, gidx_g, ent_valid,
                                                     bw_g),
                         jnp.asarray(packed))
    (d_j,) = vjp(jnp.asarray(cot))

    tb = tr.bin_gaussians(*[torch.from_numpy(a) for a in args], **kw)
    p = torch.from_numpy(packed).requires_grad_(True)
    out_t = tg.gather_entries(p, tb.gidx, tb.ent_valid)
    (d_t,) = torch.autograd.grad(out_t, p, torch.from_numpy(cot))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6,
                               rtol=1e-6)
    assert float(np.abs(np.asarray(d_j)).max()) > 0


def test_gather_cuda_wrapper_refuses_cpu_tensors():
    packed = torch.zeros((4, 9))
    gidx = torch.zeros((1, 2, 3), dtype=torch.int32)
    valid = torch.ones((1, 2, 3), dtype=torch.bool)
    before = tg.gather_entries_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tg.gather_entries_cuda(packed, gidx, valid)
    with pytest.raises(ValueError, match="CUDA"):
        tc.composite_tiles_bwd_cuda(
            torch.zeros((1, 4, 8, 9)), torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros((1, 32, 32, 3)), torch.ones((4, 256)),
            torch.ones((4,), dtype=torch.int32),
            torch.zeros((1, 32, 32, 3)), torch.zeros((1, 32, 32)), 32, 32,
            16, 2, 2)
    assert tg.gather_entries(packed, gidx, valid).shape == (1, 2, 3, 9)
    assert tg.gather_entries_cuda.launches == before
