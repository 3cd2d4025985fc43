"""Device milliseconds a request of the kernels launched in the
rasterizer's `raster/binning` span (the tile lists and their sort; the
projection excluded), over the traced window's requests."""

from benchlib.spans import per_request_device_s


def read(run):
    s = per_request_device_s(run, "raster/binning")
    return None if s is None else 1e3 * s
