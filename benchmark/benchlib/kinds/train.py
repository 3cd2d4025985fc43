"""3DGS training: the program's `run_optim` on a scene made from the seed
(every pixel of every view one Gaussian), all cameras a step, MCMC on,
called in fixed chunks of steps, each chunk holding one refine.

Set-up builds the state and drives it through its first steps with the
window's own call: one step, then two, keeping the first step's Adam
moments and the parameters after the third; then warm-up steps up to and
including a refine. The window continues the same state.

The check, once the window has closed, follows those first three steps
with the plain reference (`reference.splat`) from its own start, built
from the same scene:
  - ``step_gap``: each leaf's change over the three steps, by the worst
    leaf: |norm(program) - norm(reference)| over the larger of that
    leaf's reference norm and the median leaf's.
Printed and not held: each step's loss (the first step's reads 3e-6 to
7e-6 on sound runs and 6e-6 to 8e-5 under the TF32 control, so it has no
upper reading; the third step's reads ~2e-4 on some seeds, the same on
every run of the seed: a near-camera Gaussian, below, moves by a step
whose sign is float32 noise).
  - ``refine_gap``: the window's last refine step (its relocation, its
    growth, its moments' reset and that step's position noise), followed
    from the program's own state just before it and its generator's state
    by `reference.splat.refine`: the worst leaf's (parameters and Adam
    moments) norm of the difference over the larger of its reference norm
    and the median leaf's; a live count that differs reads infinite. (The
    refine comes hundreds of steps after the start; only the program's own
    state reaches it. The steps before it are those that ``step_gap``
    holds. Where no slot is dead and the pool is full, as in the 512 x 384
    cell's window, a refine moves nothing and a skipped one reads 0 too.)
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out. The first gradient as
Adam got it (its first moment over 1 - b1), taken the same way, is
printed and not held: a few Gaussians just in front of a camera project
to near-degenerate conics whose exponent float32 cancels, and their
gradients, zero in float64, are 1e5 times any other row's, in the
program's kernels and in its plain version and the reference alike; the
means' and scales' norms are that noise, 0.3 to 1.2 apart on every seed
(PERF.md, Open questions).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..runner import Check, worst
from . import splatbase

ADAM_B1 = 0.9


class Workload:
    def __init__(self, run):
        self.run = run
        self.tr = run.cell.traffic
        # limits of the compared numbers (checks/<cell>.json)
        self.limits = run.cell.checks["limits"]
        self.attempted = 0
        self.failed = 0
        self.steps = 0
        self.recorder = None
        self.refine = None      # the window's last refine: before, after

    def setup(self):
        import torch
        from starst3r_tpu_torch.splat import train as tr

        run, t = self.run, self.tr
        self.dev = torch.device(run.device)
        with run.phase("scene"):
            pts, cols, views, w2c, Ks = splatbase.make_scene(run)
        self.scene = (pts, cols, views, w2c, Ks)
        self.scfg = splatbase.splat_config(run)
        self.gs_seed = run.torch_seed("gaussians")
        cycle = self.scfg.mcmc_refine_every
        step0 = self.scfg.mcmc_refine_start + cycle - t["first_steps"] \
            - t["warmup_steps"]
        with run.phase("init"):
            state = splatbase.program_state(pts, cols, self.scfg,
                                            self.gs_seed, step0, self.dev)
        self.gt = torch.as_tensor(views, device=self.dev)
        self.w2c = torch.as_tensor(w2c, device=self.dev)
        self.Ks = torch.as_tensor(Ks, device=self.dev)
        keys = list(state.params)
        t0 = time.perf_counter()
        state, l1 = self._call(state, 1)
        self.first_mu = {k: state.opt_state.mu[k].clone() for k in keys}
        state, l23 = self._call(state, t["first_steps"] - 1)
        self.first_losses = list(l1) + list(l23)
        self.theta3 = {k: state.params[k].clone() for k in keys}
        state, _ = self._call(state, t["warmup_steps"])
        run.records.setdefault("setup_phases", {})["first steps"] = \
            time.perf_counter() - t0
        self.state = state
        self.tr_mod = tr

    def _call(self, state, iters: int):
        from starst3r_tpu_torch.splat.train import run_optim
        return run_optim(state, self.gt, self.w2c, self.Ks, iters, self.scfg,
                         enable_pruning=True)

    def window(self, seconds: float):
        import torch
        tr = self.tr_mod
        if self.run.trace and self.dev.type == "cuda":
            tr.stage_events = []
            self.recorder = splatbase.KernelRecorder()
        real = tr._mcmc_post_step
        tr._mcmc_post_step = self._keep_refine(real)
        t0 = time.perf_counter()
        try:
            while (time.perf_counter() - t0 - self.run.tracer.paused_s
                   < seconds):
                self.attempted += 1
                self.run.tracer.tick()
                with torch.profiler.record_function("bench/chunk"):
                    self.state, losses = self._call(self.state,
                                                    self.tr["chunk"])
                if not all(np.isfinite(losses)):
                    self.failed += 1
                self.steps += self.tr["chunk"]
        finally:
            tr._mcmc_post_step = real
            events = tr.stage_events
            tr.stage_events = None
            if self.recorder is not None:
                self.recorder.close()
        h, w = self.gt.shape[1:3]
        self.run.records.update({
            "train.steps": self.steps, "train.cameras": self.gt.shape[0],
            "train.stage_events": events or [],
            "splat.hw": (h, w), "splat.gaussians": self.state.n_alive,
            "splat.kernels": (self.recorder.last if self.recorder else {}),
            "splat.tile": self.scfg.tile_size})

    def _keep_refine(self, real):
        """`_mcmc_post_step` that keeps copies of its state before and after
        each refine step (the last one is checked)."""
        import torch

        def copy(st):
            return ({k: v.clone() for k, v in st.params.items()},
                    {k: v.clone() for k, v in st.opt_state.mu.items()},
                    {k: v.clone() for k, v in st.opt_state.nu.items()},
                    st.n_alive)

        def post_step(state, lr, cfg, mcfg, do_refine):
            if not do_refine:
                return real(state, lr, cfg, mcfg, do_refine)
            self.refine = None
            before = copy(state) + (state.generator.get_state(), lr)
            new = real(state, lr, cfg, mcfg, do_refine)
            self.refine = (before, copy(new))
            return new

        return post_step

    def end_to_end(self) -> Dict[str, float]:
        return {"train_step_ms": self.run.window_s * 1e3 / self.steps}

    def release(self):
        self.state = None
        self.run.records.pop("splat.kernels", None)

    def check(self, control: bool = False) -> List[Check]:
        """The compared numbers; with ``control`` the reference with TF32
        on stands in the program's place."""
        import torch
        from reference import splat as rs
        from reference.precision import tf32

        pts, cols, views, w2c, Ks = self.scene
        s = self.run.cell.config["splat"]
        cfg = {"tile_size": s["tile_size"], "max_per_tile": s["max_per_tile"],
               "max_tiles_per_gaussian": s["max_tiles_per_gaussian"],
               "lr": self.scfg.lr, "noise_lr": self.scfg.mcmc_noise_lr}
        n = self.tr["first_steps"]

        def follow(on: bool):
            start = rs.start(pts, cols, self.scfg.sh_bands,
                              self.scfg.init_scale, self.dev)
            with tf32(on):
                return start, rs.train(start, self.gt, self.w2c, self.Ks,
                                       cfg, n, self.gs_seed)

        start, ref = follow(False)
        if control:
            _, lo = follow(True)
            losses = [x[0] for x in lo]
            g1 = lo[0][1]
            theta3 = lo[-1][2]
        else:
            # the program's pool may hold inactive slots past the points
            # (none at this size: the points outnumber cap_max)
            n_pts = pts.shape[0]
            losses = self.first_losses
            g1 = {k: v[:n_pts] / (1 - ADAM_B1)
                  for k, v in self.first_mu.items()}
            theta3 = {k: v[:n_pts] for k, v in self.theta3.items()}
        rg = {k: float(torch.linalg.norm(v)) for k, v in ref[0][1].items()}
        med = float(np.median(list(rg.values())))
        moved = [k for k in rg if rg[k] >= 1e-3 * med]
        pg = {k: float(torch.linalg.norm(g1[k])) for k in moved}
        grad_gap = max(abs(pg[k] - rg[k]) / max(rg[k], med) for k in moved)
        rd = {k: float(torch.linalg.norm(ref[-1][2][k] - start[k]))
              for k in moved}
        med_d = float(np.median(list(rd.values())))
        pd = {k: float(torch.linalg.norm(theta3[k] - start[k]))
              for k in moved}
        step_gap = worst(*(abs(pd[k] - rd[k]) / max(rd[k], med_d)
                           for k in moved))
        self.run.records["check_details"] = {
            "grad_gap (not held)": grad_gap,
            "first loss_gap (not held)": abs(losses[0] - ref[0][0])
            / abs(ref[0][0]),
            "losses (program, reference)": [(a, b[0])
                                            for a, b in zip(losses, ref)],
            "reference budgets": [b[3] for b in ref], **{
                k: {"grad": [pg[k], rg[k]], "change": [pd[k], rd[k]]}
                for k in moved}}
        refine_gap, relocated = self._refine_gap(control)
        self.run.records["check_details"].update({
            "refine_gap": refine_gap, "refine: slots relocated": relocated})
        gaps = {"step_gap": step_gap, "refine_gap": refine_gap}
        return [Check(k, gaps[k], v) for k, v in self.limits.items()]

    def _refine_gap(self, control: bool):
        """(``refine_gap``, the slots the reference relocated); with
        ``control`` the reference refine with TF32 on stands in the
        program's place."""
        import torch
        from reference import splat as rs
        from reference.precision import tf32
        if self.refine is None:
            return float("inf"), 0
        (p0, mu0, nu0, n0, gen_state, lr), after = self.refine
        cap = self.run.cell.config["splat"]["cap_max"]

        def follow(on: bool):
            gen = torch.Generator(device=self.dev)
            gen.set_state(gen_state)
            with tf32(on), torch.no_grad():
                return rs.refine(p0, mu0, nu0, n0, cap, lr,
                                 self.scfg.mcmc_noise_lr, gen)

        ref = follow(False)
        got = follow(True)[:4] if control else after
        if got[3] != ref[3]:
            return float("inf"), ref[4]
        leaves = {f"{part}.{k}": (g[k], r[k]) for part, g, r in zip(
            ("params", "mu", "nu"), got[:3], ref[:3]) for k in r}
        norm = {k: float(torch.linalg.norm(r)) for k, (_, r) in leaves.items()}
        med = float(np.median(list(norm.values())))
        gap = worst(*(float(torch.linalg.norm(g - r)) / max(norm[k], med,
                                                             1e-30)
                      for k, (g, r) in leaves.items()))
        return gap, ref[4]
