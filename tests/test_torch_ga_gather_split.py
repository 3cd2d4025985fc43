"""The row-sum kernel's launch shape and summation order on the CPU, and
the gradient of plain indexing against the JAX package's `_gather_rows`,
at the GA's gather shapes of three operating points.

The kernel (`csrc/gather_rows_bwd.cu`) runs only on the card; what
surrounds it is Python tested here:

  (a) `ops/row_sum.py::_gather_plan`, the launch shape the host picks
      from (M, R, D): within the kernel's limits (at most 1,024 threads a
      block, 32 threads across a tile, a power-of-two number of groups, a
      cluster of 1, 2, 4 or 8 blocks, at most 65,535 column tiles, a vector
      width that divides D), and, through a numpy mirror of the kernel's
      index arithmetic (block and thread to row, rank, group and column;
      each rank's share of its row), every (entry, column) summed by
      exactly one thread, inside its own row, and every output element
      written by exactly one thread;
  (b) the gradient of ``table[idx]`` (the GA's chain on the CPU gathers
      by plain indexing) against `jax.vjp` of the JAX `_gather_rows` (its
      CPU route, a scatter-add), and `_gather_rows_bwd_in_order`, the
      kernel's exact summation order in PyTorch (the card's tests hold the
      kernel to it bit for bit), against the float64 sum. Tolerance 1e-5
      (1 + max|ref|): float32 sums of up to tens of thousands of terms in
      another order. (``index_add_`` and the JAX scatter-add both add a
      row's entries one after another: on the long row of 368,640 entries
      they agree bit for bit and sit 0.043 from the float64 sum, where the
      kernel's order, a tree over short runs, sits 0.001 from it.
      Autograd's backward of the indexing adds in an order of its own.)

The operating points: the main path's first GA (C = 4 cameras, S = 784
core points, M = 9,408 correspondences, P = 12 pairs, random indices of
those shapes), the turntable's GA state (examples/turntable_torch.py: 8
cameras, 128 px, subsample 2) and the 512 px state of
tests/test_ga_groundtruth.py::test_ga_512px_scale_memory (10 cameras, S =
4,096, M = 368,640), both built by `make_state` from `utils.synthetic`,
each site's index the state's own (tests/torch_ga_scene.py's
`state_sites`); and the edge cases of tests/torch_ga_scene.py (a long
row, a split row with an empty share, empty rows, one row, no entries).
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
from starst3r_tpu_torch.ops import row_sum
from starst3r_tpu_torch.utils.synthetic import (synthetic_ga_scene,
                                                synthetic_image_scene)
from torch_ga_scene import GATHER_SITES, gather_case, state_sites

TOL = 1e-5
POINTS = ("main", "turntable", "512px")
EDGES = ("long_row", "split_short_row", "empty_rows", "one_row",
         "no_entries")
CASES = [(p, n) for p in POINTS for n in GATHER_SITES] + [
    ("edge", n) for n in EDGES]


@pytest.fixture(scope="module")
def states():
    """The turntable's and the 512 px operating point's gather sites."""
    tt = synthetic_image_scene(n_cams=8, hw=128, subsample=2, spread=0.25,
                               focal=180.0)
    big = synthetic_ga_scene(n_cams=10, hw=512, focal=720.0, subsample=8,
                             anchored=True, orbit=True, sph_r=1.2,
                             spread=0.2)
    return {name: state_sites(ga.make_state(data, mst, GAConfig(),
                                            device="cpu"))
            for name, (data, mst) in (("turntable", tt[:2]),
                                      ("512px", big[:2]))}


def _case(point, name, states):
    """(R, idx (M,) int64 tensor, ct (M, D) float32 tensor)."""
    if point == "main":
        r, idx, ct = gather_case(name, c=4, m=9408, s=784)
    elif point == "edge" and name == "no_entries":
        r, idx, ct = 5, np.zeros(0, np.int64), np.zeros((0, 7), np.float32)
    elif point == "edge":
        r, idx, ct = gather_case(name)
    else:
        r, d, t_idx = states[point][name]
        idx = t_idx.numpy()
        ct = (3.0 * np.random.default_rng(len(idx) + d).normal(
            size=(len(idx), d))).astype(np.float32)
    return r, torch.from_numpy(idx), torch.from_numpy(ct)


def _case_id(case):
    return f"{case[0]}-{case[1]}"


def _mirror_threads(plan, rows, width):
    """Each thread of the kernel's grid, as csrc/gather_rows_bwd.cu maps it:
    (row, cluster rank, group, column, live), flat over (block x, block y,
    thread)."""
    gx, gy = plan.grid(rows, width)
    bx, by, tid = (a.reshape(-1) for a in np.meshgrid(
        np.arange(gx), np.arange(gy), np.arange(plan.threads),
        indexing="ij"))
    x = tid % plan.tile_w
    g = (tid // plan.tile_w) % plan.groups
    rb = tid // (plan.tile_w * plan.groups)
    rank = bx % plan.cluster
    r = (bx // plan.cluster) * plan.rows_per_block + rb
    col = by * plan.tile_w + x
    live = (r < rows) & (col < width // plan.vec)
    return r, rank, g, col, live


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plan_covers_every_entry_once(case, states):
    r, idx, ct = _case(*case, states)
    m, width = ct.shape
    plan = row_sum._gather_plan(m, r, width)
    gx, gy = plan.grid(r, width)
    assert 1 <= plan.threads <= 1024 and 1 <= plan.tile_w <= 32
    assert plan.groups & (plan.groups - 1) == 0
    assert plan.cluster in (1, 2, 4, 8) and gx % plan.cluster == 0
    assert width % plan.vec == 0 and plan.vec in (1, 4)
    assert gy <= 65535 and gx < 2 ** 31

    offsets = row_sum._gather_csr(idx, r)[1].numpy().astype(np.int64)
    cols = width // plan.vec
    row, rank, g, col, live = _mirror_threads(plan, r, width)
    row, rank, g, col = (a[live] for a in (row, rank, g, col))
    begin = offsets[row]
    length = offsets[row + 1] - begin
    share = -(-length // plan.cluster)
    lo = begin + np.minimum(rank * share, length)
    hi = begin + np.minimum((rank + 1) * share, length)
    cover = np.zeros((m, cols), np.int64)
    k = lo + g
    while (k < hi).any():
        on = k < hi
        np.add.at(cover, (k[on], col[on]), 1)
        # each sorted position k belongs to the thread's own row
        assert (np.searchsorted(offsets, k[on], side="right") - 1
                == row[on]).all()
        k = k + plan.groups
    assert (cover == 1).all()
    # the cluster's rank 0, group 0 writes each output element once
    written = np.zeros((r, cols), np.int64)
    out = (g == 0) & (rank == 0)
    np.add.at(written, (row[out], col[out]), 1)
    assert (written == 1).all()


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_gradient_and_kernel_order_match_jax(case, states):
    r, idx, ct = _case(*case, states)
    table = jnp.zeros((r, ct.shape[1]), jnp.float32)
    _, vjp = jax.vjp(lambda t: jga._gather_rows(
        t, jnp.asarray(idx.numpy(), jnp.int32)), table)
    want = np.asarray(vjp(jnp.asarray(ct.numpy()))[0])
    tol = TOL * (1 + np.abs(want).max(initial=0.0))

    csr = row_sum._gather_csr(idx, r)
    leaf = torch.zeros((r, ct.shape[1]), requires_grad=True)
    (grad,) = torch.autograd.grad(leaf[idx], leaf, ct)
    assert grad.shape == want.shape == (r, ct.shape[1])
    np.testing.assert_allclose(grad.numpy(), want, rtol=0, atol=tol)
    exact = row_sum._gather_rows_bwd_plain(idx, ct.double(), r).numpy()
    in_order = row_sum._gather_rows_bwd_in_order(ct, *csr)
    assert in_order.dtype == torch.float32 and in_order.shape == want.shape
    np.testing.assert_allclose(in_order.numpy(), exact, rtol=0,
                               atol=TOL * (1 + np.abs(exact).max(initial=0)))
    empty = np.bincount(idx.numpy(), minlength=r) == 0
    assert (in_order.numpy()[empty] == 0).all()
    if case[1] == "split_short_row":
        plan = row_sum._gather_plan(ct.shape[0], r, ct.shape[1])
        assert plan.cluster > 3        # the 3-entry row leaves a rank empty
