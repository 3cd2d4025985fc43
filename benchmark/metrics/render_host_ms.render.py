"""Host milliseconds a request in the rasterizer: the `raster/project`,
`raster/binning`, `raster/pack` and `raster/composite` spans (the eager
launches that pace a host-bound request), over the traced window's
requests."""

from benchlib.spans import per_request_host_s


def read(run):
    s = per_request_host_s(run, "raster/project", "raster/binning",
                           "raster/pack", "raster/composite")
    return None if s is None else 1e3 * s
