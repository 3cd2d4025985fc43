"""The slice tests' images, render bound and call recorder, without JAX,
so the GPU tests (tests/test_torch_cuda.py, run with --noconftest where JAX
may be absent) and chip_smoke.py share them with the CPU parity tests
(tests/test_torch_slice.py, tests/test_torch_rect.py)."""

import contextlib
from typing import Any, NamedTuple

import numpy as np


class Call(NamedTuple):
    args: tuple
    kw: dict
    out: Any


@contextlib.contextmanager
def recorded_calls(module, name="run_global_alignment"):
    """Replace ``module.name`` (by default a package's
    `reconstruct.run_global_alignment`, which `add_images` and
    `reconstruct_scene` call) with a wrapper that appends each call's
    arguments and result to the list this yields; the function is put
    back on exit."""
    real, calls = getattr(module, name), []

    def run(*args, **kw):
        out = real(*args, **kw)
        calls.append(Call(args, kw, out))
        return out

    setattr(module, name, run)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def smooth_images(n, seed=7, h=64, w=64):
    """Smooth colour fields (not white noise), so the random network's
    descriptors have structure to match; (3, h, w) each."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / h
    out = []
    for _ in range(n):
        f = rng.uniform(1, 4, size=(3, 2))
        ph = rng.uniform(0, 2 * np.pi, size=3)
        img = np.stack([np.sin(f[c, 0] * 6 * xx + f[c, 1] * 6 * yy + ph[c])
                        for c in range(3)])
        out.append((0.8 * img).astype(np.float32))
    return out


def close_renders(got, want):
    """|got - want| <= 1e-3 for 99% of the values and <= 1e-2 for all."""
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert err.max() <= 1e-2, err.max()
    assert np.mean(err > 1e-3) <= 0.01, np.mean(err > 1e-3)
