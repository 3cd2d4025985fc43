"""The GA's row gather with its own backward (`alignment/ga.py::
_gather_rows`) against the JAX package's (`starst3r_tpu/alignment/ga.py::
_gather_rows`, a jax.custom_vjp), on the CPU.

The port's backward is a CUDA kernel on the card (tests/test_torch_cuda.py
holds it to the plain version there); on the CPU it is the plain version,
``zeros((R, D)).index_add_(0, idx, ct)``, tested here:

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
  (b) the forward equal to ``table[idx]`` and to the JAX forward, bit for
      bit;
  (c) `torch.autograd.gradcheck` of the Function in float64;
  (d) the CSR helper: a stable argsort and the cumulative counts, and
      make_state's CSRs of the six sites;
  (e) one GA step of each phase on tests/torch_ga_scene.py's scene through
      `_gather_rows` and through plain indexing: the same loss, and
      gradients within 1e-6 of each parameter's largest magnitude (or
      absolute, where that is below 1).
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from starst3r_tpu.alignment import ga as jga

from starst3r_tpu_torch.alignment import ga
from starst3r_tpu_torch.config import GAConfig
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
    got = ga._gather_rows_bwd_plain(torch.from_numpy(idx),
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


@pytest.mark.parametrize("name", GATHER_SITES)
def test_forward_is_indexing(name):
    r, idx, ct = gather_case(name, seed=1)
    table = np.random.default_rng(1).normal(
        size=(r, ct.shape[1])).astype(np.float32)
    t_idx = torch.from_numpy(idx)
    got = ga._gather_rows(torch.from_numpy(table), t_idx,
                          ga._gather_csr(t_idx, r))
    assert torch.equal(got, torch.from_numpy(table)[t_idx])
    want = jga._gather_rows(jnp.asarray(table), jnp.asarray(idx, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d", [1, 5])
def test_gradcheck(d):
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(np.array([0, 3, 3, 1, 6, 3, 0, 6, 6, 6, 1, 4]))
    csr = ga._gather_csr(idx, 7)        # rows 2 and 5 hold no entries
    table = torch.from_numpy(rng.normal(size=(7, d))).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: ga._gather_rows(t, idx, csr),
                                    (table,))


@pytest.mark.parametrize("case", ["random", "empty_rows", "one_row",
                                  "no_entries"])
def test_csr(case):
    rng = np.random.default_rng(3)
    r = 40
    idx = {"random": rng.integers(0, r, 500),
           "empty_rows": rng.integers(5, 20, 300),
           "one_row": np.full(200, 7),
           "no_entries": np.zeros(0, np.int64)}[case]
    order, offsets = ga._gather_csr(torch.from_numpy(idx), r)
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


def test_make_state_builds_each_gathers_csr():
    """make_state builds the six sites' row order once for both phases,
    from the state's own indices (depth rows img * S + idx)."""
    data, mst = ga_scene(4)
    state = ga.make_state(data, mst, GAConfig(), device="cpu")
    c, s = state.imsizes.shape[0], state.core_pix.shape[0]
    want = {"depth1": (state.corr_img1 * s + state.corr_idx1, c * s),
            "depth2": (state.corr_img2 * s + state.corr_idx2, c * s),
            "img1": (state.corr_img1, c), "img2": (state.corr_img2, c),
            "pair_img1": (state.pair_img1, c),
            "pair_img2": (state.pair_img2, c)}
    assert set(state.gathers._fields) == set(want)
    for name, (idx, r) in want.items():
        got_idx, got_csr = getattr(state.gathers, name)
        assert torch.equal(got_idx, idx)
        for a, b in zip(got_csr, ga._gather_csr(idx, r)):
            assert torch.equal(a, b)


def test_csr_refuses_an_index_past_the_table():
    with pytest.raises(ValueError, match="past the table"):
        ga._gather_csr(torch.tensor([0, 3, 9]), 5)


def test_backward_refuses_other_devices():
    """Only a CPU tensor takes the plain version; the kernel's wrapper
    takes only CUDA tensors."""
    idx = torch.tensor([0, 2, 2])
    csr = ga._gather_csr(idx, 3)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ga.gather_rows_bwd_cuda(torch.ones((3, 2)), *csr)
    meta = lambda t: t.to("meta")
    table = torch.ones((3, 2), device="meta", requires_grad=True)
    out = ga._gather_rows(table, meta(idx), tuple(map(meta, csr)))
    with pytest.raises(ValueError, match="no row-gather backward"):
        out.sum().backward()


def _indexing(table, idx, csr):
    return table[idx]


@pytest.mark.parametrize("phase", [1, 2])
def test_ga_step_matches_plain_indexing(phase, monkeypatch):
    data, mst = ga_scene(4)
    cfg = GAConfig(niter1=15, niter2=8)
    state = ga.make_state(data, mst, cfg, device="cpu")
    launches = ga.gather_rows_bwd_cuda.launches

    def loss_and_grads():
        ph = ga._Phase(ga.init_params(data, device="cpu"), state, 15, 0.07,
                       1e-6, 1.5, phase, cfg)
        loss = ph.loss(torch.tensor(0.5))
        return loss, torch.autograd.grad(loss, ph.params)

    loss, grads = loss_and_grads()
    monkeypatch.setattr(ga, "_gather_rows", _indexing)
    want_loss, want_grads = loss_and_grads()
    assert torch.equal(loss, want_loss)
    for g, w in zip(grads, want_grads):
        torch.testing.assert_close(
            g, w, rtol=0, atol=1e-6 * max(float(w.abs().max()), 1.0))
    assert ga.gather_rows_bwd_cuda.launches == launches
