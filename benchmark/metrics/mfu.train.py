"""The training step's share of the card's float32 peak (every operation
of the step is float32 on the CUDA cores): the step's counted operations
(`benchlib.readers.splat_ops`, from the last step's lists) times the
window's steps, over the window's seconds times 67 TFLOP/s."""

from benchlib import device
from benchlib.readers import splat_ops


def read(run):
    ops = splat_ops(run, backward=True)
    steps = run.records.get("train.steps")
    if ops is None or not steps:
        return None
    return 100.0 * ops * steps / (run.window_s * device.PEAK_F32)
