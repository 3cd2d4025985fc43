"""Device milliseconds a scene in the program's `recon/dense` span (the
feed-forward branch's unprojection of every view's depth with its camera;
no clean-up in this cell): the kernels launched inside it, found by their
correlation ids wherever they ran, over the traced window's requests."""

from benchlib.spans import per_request_device_s


def read(run):
    s = per_request_device_s(run, "recon/dense")
    return None if s is None else 1e3 * s
