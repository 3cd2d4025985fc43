"""A render request's share of the card's float32 peak: its counted
operations (projection and compositing, from the last request's lists)
times the window's requests, over the window's seconds times 67
TFLOP/s."""

from benchlib import device
from benchlib.readers import splat_ops


def read(run):
    ops = splat_ops(run, backward=False)
    n = run.records.get("render.requests")
    if ops is None or not n:
        return None
    return 100.0 * ops * n / (run.window_s * device.PEAK_F32)
