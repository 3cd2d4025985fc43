"""Device milliseconds a scene in the program's `fast3r/fuse` span (the
fusion blocks, their attention included): the kernels launched inside
it, found by their correlation ids wherever they ran, over the traced
window's requests."""

from benchlib.spans import per_request_device_s


def read(run):
    s = per_request_device_s(run, "fast3r/fuse")
    return None if s is None else 1e3 * s
