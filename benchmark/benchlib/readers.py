"""Helpers the per-layer metric readers share. A reader returns None when
its run holds nothing for it to read; the harness then leaves the metric
out of the line. A share of a roofline or of a peak is never 0 for want
of data."""

from __future__ import annotations

from typing import Optional

from . import device as devmod
from . import work


def idle_share(run) -> Optional[float]:
    """100 (1 - device busy / window) over the traced window."""
    tr = run.tracer
    if tr is None or not tr.busy_s or not tr.window_s:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def stage_ms(run, stage: str) -> Optional[float]:
    """Stream ms a training step in ``stage``: the program's own CUDA
    events of the traced window's steps (`splat.train.stage_events`)."""
    events = run.records.get("train.stage_events")
    steps = run.records.get("train.steps")
    if not events or not steps:
        return None
    import torch
    torch.cuda.synchronize()
    total = sum(s.elapsed_time(e) for name, s, e in events if name == stage)
    return total / steps


def _last(run, name):
    kernels = run.records.get("splat.kernels") or {}
    return kernels.get(name)


def composite_inputs(run):
    """(packed, gidx, counts, h, w, tile) of the last forward call the
    window made, or None."""
    args = _last(run, "composite_packed_cuda")
    if args is None:
        return None
    packed, gidx, counts, h, w, tile = args[:6]
    return packed, gidx, counts, h, w, tile


def composite_counts(run):
    """`work.composite_work` of the last forward call, computed once."""
    if "splat.work" not in run.records:
        inp = composite_inputs(run)
        run.records["splat.work"] = (
            None if inp is None else work.composite_work(*inp))
    return run.records["splat.work"]


def fwd_roofline(run) -> Optional[float]:
    """100 x least time / device time of the forward kernel's entry on the
    last call's inputs."""
    args = _last(run, "composite_packed_cuda")
    wk = composite_counts(run)
    if args is None or wk is None:
        return None
    from starst3r_tpu_torch.splat import composite as comp
    ms = run.timer.device_ms(lambda: comp.composite_packed_cuda(*args), 20)
    ops, nbytes = work.composite_fwd_cost(wk)
    t, bound = work.least_time(ops, nbytes, devmod.PEAK_F32,
                               devmod.PEAK_BYTES)
    run.records.setdefault("roofline", {})["composite_fwd"] = (
        t * 1e3, ms, bound)
    return 100.0 * t * 1e3 / ms


def bwd_roofline(run) -> Optional[float]:
    """The same of the backward's entry (the backward kernel, the row
    order and the row sum) on the last backward call's inputs."""
    args = _last(run, "composite_packed_bwd_cuda")
    wk = composite_counts(run)
    if args is None or wk is None:
        return None
    from starst3r_tpu_torch.splat import composite as comp
    ms = run.timer.device_ms(lambda: comp.composite_packed_bwd_cuda(*args),
                             10)
    ops, nbytes = work.composite_bwd_cost(wk)
    t, bound = work.least_time(ops, nbytes, devmod.PEAK_F32,
                               devmod.PEAK_BYTES)
    run.records.setdefault("roofline", {})["composite_bwd"] = (
        t * 1e3, ms, bound)
    return 100.0 * t * 1e3 / ms


def splat_ops(run, backward: bool) -> Optional[float]:
    """Float32 operations of one render of the recorded call's cameras
    (``backward``: of one training step: the render, its backward, the
    SSIM loss and its backward, Adam)."""
    wk = composite_counts(run)
    if wk is None:
        return None
    h, w = run.records["splat.hw"]
    n = run.records["splat.gaussians"]
    cams = wk["pixels"] / (h * w)
    ops = work.composite_fwd_cost(wk)[0] + work.PROJ_OPS * n * cams
    if backward:
        ops += work.composite_bwd_cost(wk)[0] + 2 * work.PROJ_OPS * n * cams
        ops += 3 * work.SSIM_OPS * 3 * h * w * cams          # fwd + bwd
        ops += work.ADAM_OPS * work.GAUSSIAN_PARAMS * n
    return ops
