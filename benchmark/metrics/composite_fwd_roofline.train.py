"""The forward compositing kernel's entry (`composite_packed_cuda`, K1)
on the inputs of the window's last step: the least time the algorithm's
work needs on the card (`benchlib.work`: operations at the float32 peak
or bytes at the memory rate, the larger) over its device time
(`device.KernelTimer.device_ms`), in percent."""

from benchlib.readers import fwd_roofline


def read(run):
    return fwd_roofline(run)
