"""The GA's row gathers on the CPU: the row-sum kernel's plain version
(`ops/row_sum.py::_gather_rows_bwd_plain`) against the JAX package's
gather backward (`starst3r_tpu/alignment/ga.py::_gather_rows`, a
jax.custom_vjp), the rows' order that the fused loss reads, and the
gradient of the losses' chain, whose gathers are plain indexing.

The kernel (`csrc/gather_rows_bwd.cu`) runs only on the card
(tests/test_torch_cuda.py holds it to the plain version there); its plain
version is ``zeros((R, D)).index_add_(0, idx, ct)``, tested here:

  (a) against `jax.vjp` of the JAX `_gather_rows` (its CPU route, a
      scatter-add) and against the arithmetic of its TPU route, the one-hot
      contraction (dense over the camera rows, `_factored_onehot_colsum`
      for the D = 1 depth gather), at the six gather sites' shapes on the
      main path (C = 4 and 6 cameras, S = 784 core points, M = 20,000
      correspondences, P = C (C - 1) pairs; tests/torch_ga_scene.py's
      `gather_case`), and on an index with empty rows and one whose
      entries all fall in one row. Tolerance
      1e-5 (1 + max|ref|): float32 sums of up to thousands of terms in
      another order;
  (b) the CSR helper `_gather_csr`: a stable argsort and the cumulative
      counts;
  (c) the fused loss's static orders (`ga_loss.make_loss_data`): each
      side's correspondences by their depth rows and the pairs by each of
      their cameras, each `_gather_csr` of the state's own index, each
      row's entries in their order;
  (d) `torch.autograd.gradcheck` in float64 of the losses' chain
      (`ga._loss_3d`, `ga._loss_2d`, `ga._loss_dust3r` on
      `ga._core_pts3d`) with respect to K, cam2w, the core depth and proj,
      on a 3-camera scene.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from starst3r_tpu.alignment import ga as jga

from starst3r_tpu_torch.alignment import ga
from starst3r_tpu_torch.alignment import ga_loss as gl
from starst3r_tpu_torch.config import GAConfig
from starst3r_tpu_torch.ops import row_sum
from torch_ga_scene import GATHER_SITES, ga_scene, gather_case

TOL = 1e-5
CASES = [(n, c) for c in (4, 6) for n in GATHER_SITES] + ["empty_rows",
                                                          "one_row"]


def _one_hot_route(idx, ct, r, monkeypatch):
    """The JAX TPU route's arithmetic, run on the CPU: the factored one-hot
    for D = 1, the dense one-hot over the camera rows otherwise."""
    j_idx = jnp.asarray(idx, jnp.int32)
    if ct.shape[1] == 1:
        return np.asarray(jga._factored_onehot_colsum(j_idx, jnp.asarray(ct),
                                                      r))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    d, _ = jga._gather_rows_bwd((j_idx, r), jnp.asarray(ct))
    monkeypatch.undo()
    return np.asarray(d)


@pytest.mark.parametrize(
    "case", CASES,
    ids=lambda c: c if isinstance(c, str) else f"{c[0]}-C{c[1]}")
def test_plain_backward_matches_jax(case, monkeypatch):
    r, idx, ct = (gather_case(case) if isinstance(case, str)
                  else gather_case(*case))
    got = row_sum._gather_rows_bwd_plain(torch.from_numpy(idx),
                                         torch.from_numpy(ct), r).numpy()
    table = jnp.zeros((r, ct.shape[1]), jnp.float32)
    _, vjp = jax.vjp(lambda t: jga._gather_rows(t, jnp.asarray(idx,
                                                               jnp.int32)),
                     table)
    scatter = np.asarray(vjp(jnp.asarray(ct))[0])
    one_hot = _one_hot_route(idx, ct, r, monkeypatch)
    assert got.shape == scatter.shape == one_hot.shape == (r, ct.shape[1])
    for ref in (scatter, one_hot):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=TOL * (1 + np.abs(ref).max()))
    empty = np.bincount(idx, minlength=r) == 0
    assert (got[empty] == 0).all()
    if case == "one_row":
        assert empty.sum() == r - 1


@pytest.mark.parametrize("case", ["random", "empty_rows", "one_row",
                                  "no_entries"])
def test_csr(case):
    rng = np.random.default_rng(3)
    r = 40
    idx = {"random": rng.integers(0, r, 500),
           "empty_rows": rng.integers(5, 20, 300),
           "one_row": np.full(200, 7),
           "no_entries": np.zeros(0, np.int64)}[case]
    order, offsets = row_sum._gather_csr(torch.from_numpy(idx), r)
    assert order.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(idx, kind="stable"))
    np.testing.assert_array_equal(
        offsets.numpy(), np.concatenate([[0], np.cumsum(
            np.bincount(idx, minlength=r))]))
    # row r's entries, in their order in idx
    for row in range(r):
        ks = order.numpy()[offsets[row]:offsets[row + 1]]
        np.testing.assert_array_equal(ks, np.flatnonzero(idx == row))


def test_csr_refuses_an_index_past_the_table():
    with pytest.raises(ValueError, match="past the table"):
        row_sum._gather_csr(torch.tensor([0, 3, 9]), 5)


def _state(n_cams=4):
    data, mst = ga_scene(n_cams)
    return ga.make_state(data, mst, GAConfig(), device="cpu")


@pytest.mark.parametrize("order", ["depth1", "depth2", "pair_img1",
                                   "pair_img2"])
def test_loss_data_orders_each_side_by_its_rows(order):
    """Each of the fused loss's orders and offsets is `_gather_csr` of the
    state's own index (the depth rows img * S + idx over the C * S rows of
    the core depth; the pairs' cameras), and each row's entries keep their
    order in the index."""
    state = _state()
    ii = gl.make_loss_data(state, 1, 1.5, 1.5, 0.01).ints()
    c, s = state.imsizes.shape[0], state.core_pix.shape[0]
    if order.startswith("depth"):
        e = order[-1]
        img, at = getattr(state, f"corr_img{e}"), getattr(state,
                                                          f"corr_idx{e}")
        idx, r = img * s + at, c * s
        got_off = ii[f"off{e}"]
        ids = torch.stack([state.corr_img1, state.corr_img2,
                           state.corr_img1 * s + state.corr_idx1,
                           state.corr_img2 * s + state.corr_idx2], 1)
        csr_order, csr_off = row_sum._gather_csr(idx, r)
        assert torch.equal(ii[f"ids{e}"].long(), ids[csr_order.long()])
        got = ii[f"ids{e}"].long().numpy()
        for row in np.flatnonzero(np.bincount(idx.numpy(), minlength=r)):
            np.testing.assert_array_equal(
                got[got_off[row]:got_off[row + 1]],
                ids.numpy()[np.flatnonzero(idx.numpy() == row)])
    else:
        e = order[-1]
        idx, r = getattr(state, order), c
        got_off, got_order = ii[f"poff{e}"], ii[f"porder{e}"]
        csr_order, csr_off = row_sum._gather_csr(idx, r)
        assert torch.equal(got_order, csr_order)
        for row in range(r):
            np.testing.assert_array_equal(
                got_order[got_off[row]:got_off[row + 1]].numpy(),
                np.flatnonzero(idx.numpy() == row))
    assert torch.equal(got_off, csr_off)
    assert got_off.dtype == torch.int32 and int(got_off[-1]) == idx.numel()


@pytest.mark.parametrize("loss", ["_loss_3d", "_loss_2d", "_loss_dust3r"])
def test_chain_gradcheck(loss):
    """The losses' chain in float64, its gathers plain indexing: autograd's
    gradient with respect to K, cam2w, the core depth and (phase 2) proj
    against finite differences, on the 3-camera scene at a perturbed
    start."""
    state = _state(3)
    state = state._replace(**{
        k: v.double() for k, v in state._asdict().items()
        if isinstance(v, torch.Tensor) and v.is_floating_point()})
    data, _ = ga_scene(3)
    g = torch.Generator().manual_seed(0)
    params = ga.GAParams(*[
        p.double() + 0.05 * torch.randn(p.shape, generator=g).double()
        for p in ga.init_params(data, device="cpu")])
    K, w2c, cam2w, depth = [t.detach() for t in ga.make_K_cam_depth(
        params, state)]
    alpha = torch.tensor(0.7, dtype=torch.float64)
    fn = {"_loss_3d": lambda K, cam2w, depth: ga._loss_3d(
              K, cam2w, depth, state, 1.5, alpha),
          "_loss_2d": lambda K, cam2w, depth, proj: ga._loss_2d(
              K, cam2w, depth, proj, state, 1.5, alpha),
          "_loss_dust3r": lambda K, cam2w, depth: ga._loss_dust3r(
              ga._core_pts3d(K, cam2w, depth, state), cam2w, state, 1.5)
          }[loss]
    inputs = [K, cam2w, depth] + ([K @ w2c[:, :3]] if loss == "_loss_2d"
                                  else [])
    inputs = [t.clone().requires_grad_(True) for t in inputs]
    assert float(fn(*inputs).detach()) > 0
    assert torch.autograd.gradcheck(fn, inputs)
