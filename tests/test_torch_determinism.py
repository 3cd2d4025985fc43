"""The packed gradient's fixed-order sum on the CPU: the row order the card
sums K2's per-slot gradient in, against the JAX package's ``bw_idx``.

On the card K2 stores each slot's gradient and the row-sum kernel
(`ops/row_sum.py::gather_rows_bwd_cuda`) sums each table row's slots
through `splat.composite.packed_csr`; `_gather_rows_bwd_in_order` repeats
the kernel's summation order in PyTorch, so these tests see the card's
arithmetic without the card:

  (a) each row's slots in the CSR are the valid entries of the JAX
      package's globalized ``Bins.bw_idx`` row (`_globalize_bins`), as
      sets, in ascending position (the reference's second sort is
      unstable within a Gaussian, so its rows are compared sorted);
  (b) the in-order sum of a seeded slot cotangent through the CSR against
      ``jax.vjp`` of JAX's `_gather_packed`, within 1e-6 of the largest
      magnitude: float32 sums of the same terms in another order;
  (c) `_gather_rows_bwd_in_order` with an ``order`` that runs past
      offsets[R] (slots in no row) equals the same call on the trimmed
      ``order`` bit for bit, at launch plans with several groups and a
      cluster;
  (d) the cases include tiles capped at K (overflow) and empty tiles.

The GPU tests (tests/test_torch_cuda.py) hold the kernels to these bits.
"""

import functools
import importlib

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

from starst3r_tpu_torch.ops import row_sum as rs
from starst3r_tpu_torch.splat import composite as tc

from test_torch_rasterize import KW, KW_MULTI, _scene

jr = importlib.import_module("starst3r_tpu.splat.rasterize")
tr = importlib.import_module("starst3r_tpu_torch.splat.rasterize")

# the in-order sum against JAX's fori_loop sum: float32 sums of at most
# max_tiles_per_gaussian terms each, in another order, over the largest
# magnitude of the JAX gradient
VJP_SCALED_TOL = 1e-6

_BIN_KEYS = ("width", "height", "sh_degree", "tile_size",
             "max_tiles_per_gaussian", "max_per_tile")
CASES = {
    "scene": (96, KW),
    "multichunk": (1400, KW_MULTI),
    # tiles capped at K (entries dropped) and Gaussians clipped to 2 tiles
    "capped": (96, dict(KW, max_per_tile=16, max_tiles_per_gaussian=2)),
    # a wide image: the tiles right of the scene hold no entry
    "empty_tiles": (96, dict(KW, width=96)),
}


@functools.lru_cache(maxsize=None)
def _bins(case):
    """(the port's gidx (C, T, K) and counts (C, T), JAX's globalized gidx,
    ent_valid and bw_idx, N) of a case's binning."""
    n, kw = CASES[case]
    kw = {k: kw[k] for k in _BIN_KEYS}
    args = _scene(n=n)
    tb = tr.bin_gaussians(*[torch.from_numpy(a) for a in args], **kw)
    jb = jr.bin_gaussians(*[jnp.asarray(a) for a in args], **kw)
    gidx_g, ent_valid, bw_g = jr._globalize_bins(
        jb.gidx, jb.ent_valid, jb.bw_idx, n, kw["max_per_tile"])
    return tb.gidx, tb.counts, gidx_g, ent_valid, bw_g, n


def _csr(case):
    gidx, counts, _, _, _, n = _bins(case)
    return tc.packed_csr(gidx, counts, gidx.shape[0] * n)


@pytest.mark.parametrize("case", list(CASES))
def test_case_has_what_it_is_for(case):
    gidx, counts, *_ = _bins(case)
    k = gidx.shape[-1]
    n_valid = int(counts.sum())
    assert 0 < n_valid <= gidx.numel()
    if case in ("scene", "empty_tiles"):
        # slots past the counts: the CSR's tail
        assert n_valid < gidx.numel()
    if case == "capped":
        assert int(counts.max()) == k
    if case == "empty_tiles":
        assert int((counts == 0).sum()) > 0
    if case == "multichunk":
        assert int(counts.max()) > 128


@pytest.mark.parametrize("case", list(CASES))
def test_csr_rows_are_jax_bw_idx_rows(case):
    """(a): row r's slots order[offsets[r]:offsets[r+1]] ascend and are,
    as a set, the entries of JAX's bw_idx row r below its sentinel."""
    gidx, counts, gidx_g, _, bw_g, n = _bins(case)
    order, offsets = _csr(case)
    bw = np.sort(np.asarray(bw_g), axis=1)
    sentinel = gidx.numel()
    assert bw.shape[0] == gidx.shape[0] * n == offsets.numel() - 1
    np.testing.assert_array_equal(np.diff(offsets.numpy()),
                                  (bw < sentinel).sum(1))
    n_valid = int(offsets[-1])
    assert n_valid == int(counts.sum())
    np.testing.assert_array_equal(order[:n_valid].numpy(), bw[bw < sentinel])
    # and the slots in each row hold that row's index (JAX's gidx too)
    flat = gidx.reshape(-1).long()
    rows = torch.repeat_interleave(torch.arange(offsets.numel() - 1),
                                   torch.diff(offsets.long()))
    np.testing.assert_array_equal(flat[order[:n_valid].long()].numpy(),
                                  rows.numpy())
    np.testing.assert_array_equal(
        np.asarray(gidx_g).reshape(-1)[order[:n_valid].numpy()],
        rows.numpy())


@pytest.mark.parametrize("case", list(CASES))
def test_csr_tail_holds_the_invalid_slots(case):
    """The slots at or past each tile's count come after offsets[R], in
    ascending position, whatever rows their indices point at."""
    gidx, counts, *_ = _bins(case)
    order, offsets = _csr(case)
    valid = tc.slot_valid(gidx, counts).reshape(-1)
    tail = order[int(offsets[-1]):].long()
    assert tail.numel() == int((~valid).sum())
    assert not bool(valid[tail].any())
    assert bool((torch.diff(tail) > 0).all())
    assert order.dtype == offsets.dtype == torch.int32


@pytest.mark.parametrize("case", list(CASES))
def test_in_order_sum_matches_jax_gather_packed_vjp(case):
    """(b): the in-order sum of a seeded slot cotangent against
    ``jax.vjp`` of `_gather_packed` through its bw_idx."""
    gidx, counts, gidx_g, ent_valid, bw_g, n = _bins(case)
    c = gidx.shape[0]
    rng = np.random.default_rng(5)
    packed = rng.normal(size=(c * n, 9)).astype(np.float32)
    cot = rng.normal(size=tuple(gidx.shape) + (9,)).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jr._gather_packed(p, gidx_g, ent_valid,
                                                 bw_g), jnp.asarray(packed))
    (d_j,) = vjp(jnp.asarray(cot))
    d_j = np.asarray(d_j)
    got = rs._gather_rows_bwd_in_order(torch.from_numpy(cot).reshape(-1, 9),
                                       *_csr(case))
    scale = float(np.abs(d_j).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy() / scale, d_j / scale, rtol=0,
                               atol=VJP_SCALED_TOL)
    # rows no valid slot points at (if any) are exactly 0 on both sides
    empty = np.diff(_csr(case)[1].numpy()) == 0
    assert not np.abs(got.numpy()[empty]).any()
    assert not np.abs(d_j[empty]).any()


@pytest.mark.parametrize("m,r,d,invalid", [
    (2000, 600, 9, 0.5),        # the packed shape: one group a row
    (4000, 50, 9, 0.3),         # several groups a row
    (60000, 6, 9, 0.2),         # a cluster of blocks a row
    (50000, 10, 16, 0.4),       # float4 loads, a cluster
    (300, 40, 1, 0.9)])
def test_in_order_ignores_an_order_tail(m, r, d, invalid):
    """(c): entries of ``order`` past offsets[R] are never read: the call
    equals the one on the trimmed ``order`` bit for bit (the plan comes
    from ct's shape in both), and it sums what index_add_ sums."""
    rng = np.random.default_rng(m + r)
    idx = torch.from_numpy(rng.integers(0, r, size=m))
    valid = torch.from_numpy(rng.uniform(size=m) >= invalid)
    ct = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32))
    order, offsets = rs.masked_csr(idx, valid, r)
    n_valid = int(offsets[-1])
    assert 0 < n_valid < m
    got = rs._gather_rows_bwd_in_order(ct, order, offsets)
    trimmed = rs._gather_rows_bwd_in_order(ct, order[:n_valid], offsets)
    assert torch.equal(got, trimmed)
    want = torch.zeros((r, d), dtype=torch.float64).index_add_(
        0, idx[valid], ct[valid].double())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                               atol=1e-5 * (1 + float(want.abs().max())))
    plan = rs._gather_plan(m, r, d)
    if (m, r) == (60000, 6):
        assert plan.cluster > 1 and plan.groups > 1


def test_masked_csr_with_every_entry_valid_is_gather_csr():
    rng = np.random.default_rng(3)
    idx = torch.from_numpy(rng.integers(0, 17, size=500))
    got = rs.masked_csr(idx, torch.ones(500, dtype=torch.bool), 17)
    want = rs._gather_csr(idx, 17)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a, b)


def test_index_add_rows_on_the_cpu_is_index_add():
    """The CPU route of the polish's sums: the pairs' index_add_ in turn,
    in place, bit for bit."""
    rng = np.random.default_rng(4)
    pairs = [(torch.from_numpy(rng.integers(0, 12, size=n)),
              torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)))
             for n in (40, 7, 300)]
    want = torch.zeros((12, 3))
    for idx, v in pairs:
        want.index_add_(0, idx, v)
    out = torch.zeros((12, 3))
    assert rs.index_add_rows(out, *pairs) is out
    assert torch.equal(out, want)


def test_row_sum_cuda_wrappers_refuse_cpu_tensors():
    before = (rs.gather_rows_bwd_cuda.launches,
              tc.composite_packed_slots_cuda.launches)
    order, offsets = rs.masked_csr(torch.tensor([0, 2, 1]),
                                   torch.tensor([True, False, True]), 3)
    with pytest.raises(ValueError, match="CUDA"):
        rs.gather_rows_bwd_cuda(torch.ones((3, 9)), order, offsets)
    assert (rs.gather_rows_bwd_cuda.launches,
            tc.composite_packed_slots_cuda.launches) == before
