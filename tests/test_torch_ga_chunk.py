"""The GA's phases walked in chunks of `GAConfig.jit_chunk` steps with one
host read per chunk, and its NaN freeze, against the JAX package.

On the scene of tests/test_torch_ga.py (64 px, 4 cameras, 15 + 8 steps):

  - on the CPU the steps run eagerly, so every ``jit_chunk`` gives the same
    result bit for bit (the JAX package's chunked == unchunked), and the
    loss is read to the host once per chunk: ceil(niter / jit_chunk) reads
    a phase, counted in `_optimize_phase.host_reads`;
  - the NaN freeze (a ``where`` on the device, no host read) agrees with
    the JAX package's at tests/test_torch_ga.py's 1e-4. ``lr1 = 40`` sends
    the scale parameters to +-40 in one step, so the coarse loss leaves the
    finite range at the phase's second step and the fine loss at its first;
    the root camera is frozen, which pins the scene's free rigid motion
    (tests/test_torch_ga.py) and lets the params be compared as they are.
    A NaN correspondence confidence makes both losses non-finite at step
    0: the params stay at their initial values and both phase losses are
    inf.
"""

import numpy as np
import pytest
import torch
from torch_ga_scene import ga_scene
from torch_threads import one_torch_thread  # noqa: F401

from starst3r_tpu.alignment.condense import CondensedData as JCondensedData
from starst3r_tpu.alignment.ga import run_global_alignment as j_run_ga
from starst3r_tpu.config import GAConfig

from starst3r_tpu_torch.alignment import ga
from starst3r_tpu_torch.config import GAConfig as TGAConfig

FAST = dict(niter1=15, niter2=8)
TOL = 1e-4
ROOT_FROZEN = np.array([True, False, False, False])


def _nan_conf_scene():
    data, mst = ga_scene(4)
    conf = data.corr_conf.copy()
    conf[0] = np.nan
    return data._replace(corr_conf=conf), mst


# name: (scene, GAConfig keywords, freeze)
CASES = {
    "default": (ga_scene, {}, None),
    "freeze_late": (ga_scene, dict(lr1=40.0), ROOT_FROZEN),
    "freeze_step0": (_nan_conf_scene, {}, None),
}


def _run(case, chunk):
    make, kw, freeze = CASES[case]
    data, mst = make()
    ga._optimize_phase.host_reads = 0
    res, params = ga.run_global_alignment(
        data, mst, TGAConfig(**FAST, **kw, jit_chunk=chunk), freeze=freeze,
        device="cpu")
    return res, params, ga._optimize_phase.host_reads


_REFERENCE = {}


def _reference(case):
    """The case at the default chunk (50: one chunk a phase)."""
    if case not in _REFERENCE:
        _REFERENCE[case] = _run(case, 50)
    return _REFERENCE[case]


@pytest.mark.parametrize("chunk", [1, 7, 50])
@pytest.mark.parametrize("case", sorted(CASES))
def test_jit_chunk_is_bit_identical_with_one_read_per_chunk(case, chunk):
    res, params, reads = _run(case, chunk)
    want_res, want_params, _ = _reference(case)
    assert reads == sum(-(-n // chunk) for n in FAST.values())
    for name, got, want in zip(ga.GAParams._fields, params, want_params):
        assert torch.equal(got, want), name
    for name in ("K", "w2c", "cam2w", "depth", "pts3d"):
        assert torch.equal(getattr(res, name), getattr(want_res, name)), name
    assert (res.loss_coarse, res.loss_fine) == (want_res.loss_coarse,
                                                want_res.loss_fine)


@pytest.mark.parametrize("case", ["freeze_late", "freeze_step0"])
def test_nan_freeze_matches_jax(case):
    make, kw, freeze = CASES[case]
    data, mst = make()
    j_res, j_params = j_run_ga(JCondensedData(**data._asdict()), mst,
                               GAConfig(**FAST, **kw), freeze=freeze)
    t_res, t_params, _ = _run(case, 7)
    for name, got, want in zip(ga.GAParams._fields, t_params, j_params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=name)
    for name in ("K", "cam2w", "depth"):
        np.testing.assert_allclose(
            getattr(t_res, name).numpy(), np.asarray(getattr(j_res, name)),
            rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(t_res.loss_coarse, j_res.loss_coarse,
                               rtol=TOL)
    np.testing.assert_allclose(t_res.loss_fine, j_res.loss_fine, rtol=TOL)
    assert t_res.loss_fine == np.inf
    if case == "freeze_late":
        # the coarse phase kept its first step's loss and update
        assert np.isfinite(t_res.loss_coarse)
        assert float(t_params.log_sizes.abs().max()) > 30.0
    else:
        assert t_res.loss_coarse == np.inf
        init = ga.init_params(data, device="cpu")
        for name, got, want in zip(ga.GAParams._fields, t_params, init):
            assert torch.equal(got, want), name
