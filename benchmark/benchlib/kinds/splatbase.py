"""What the 3DGS kinds share: the scene made from the seed, the program's
state built from it, and the recorder of the compositing kernels' inputs
(traced runs only)."""

from __future__ import annotations

import numpy as np

from ..scenes import splat_scene


def make_scene(run):
    """(points, colours, views, w2c, K) of the traffic's scene; the seed
    shifts the texture's phases."""
    sc = run.cell.traffic["scene"]
    hw = tuple(run.cell.traffic["image_hw"])
    shift = run.rng("texture").uniform(0.0, 2 * np.pi, 3)
    return splat_scene(sc["cameras"], hw, sc["focal_frac"], sc["sphere_r"],
                       sc["backdrop"], sc["spread"], shift)


def splat_config(run):
    """The program's SplatConfig: its defaults, with the configuration's
    splatting settings."""
    from starst3r_tpu_torch.config import SplatConfig
    s = run.cell.config["splat"]
    return SplatConfig(
        tile_size=s["tile_size"], max_per_tile=s["max_per_tile"],
        max_tiles_per_gaussian=s["max_tiles_per_gaussian"],
        cap_max=s["cap_max"], mcmc_refine_every=s["mcmc_refine_every"],
        mcmc_refine_start=s["mcmc_refine_start"], sh_degree=s["sh_degree"],
        sh_bands=s["sh_bands"])


def program_state(pts, cols, scfg, seed: int, step: int, device):
    """The program's Gaussians, one a point, in a pool of
    min(cap_max, 2 N) slots or N where that is fewer (init_3dgs' rule),
    with the step counter at ``step``."""
    from starst3r_tpu_torch.splat.train import init_gaussians
    pool = min(scfg.cap_max, int(scfg.pool_headroom * pts.shape[0]))
    st = init_gaussians(pts, cols, scfg, seed=seed, pool_size=pool,
                        device=device)
    return st._replace(step=step)


class KernelRecorder:
    """Keeps the arguments of the last call of the compositing kernels'
    entries (`splat.composite.composite_packed_cuda` and
    `composite_packed_bwd_cuda`, which `CompositePacked` calls by module
    name) for the roofline readers; restores them on `close`. A wrapper
    carries its function's launch counter (the function counts its
    launches on the module name), handed back on `close`."""

    NAMES = ("composite_packed_cuda", "composite_packed_bwd_cuda")

    def __init__(self):
        import starst3r_tpu_torch.splat.composite as comp
        self.mod, self.last, self.orig = comp, {}, {}
        for name in self.NAMES:
            fn = getattr(comp, name)
            self.orig[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kw):
                self.last[_name] = args
                return _fn(*args, **kw)

            if hasattr(fn, "launches"):
                wrapped.launches = fn.launches
            setattr(comp, name, wrapped)

    def close(self):
        for name, fn in self.orig.items():
            wrapped = getattr(self.mod, name)
            if hasattr(fn, "launches"):
                fn.launches = wrapped.launches
            setattr(self.mod, name, fn)
        self.orig = {}
