"""Device milliseconds a scene in the program's `vggt/camera` and
`vggt/heads` spans (the camera head, the depth and point DPT heads): the
kernels launched inside them over the traced window's requests."""

from benchlib.spans import per_request_device_s


def read(run):
    parts = [per_request_device_s(run, n)
             for n in ("vggt/camera", "vggt/heads")]
    if all(p is None for p in parts):
        return None
    return 1e3 * sum(p for p in parts if p is not None)
