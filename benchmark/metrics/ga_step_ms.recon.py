"""Host milliseconds a replayed alignment step: the `ga/chunk` spans of
`_optimize_phase` (each chunk's graph replays and the host read that ends
it, which waits for the device's steps) over the `cudaGraphLaunch` calls
made inside them, in the traced window."""

from benchlib.spans import of


def read(run):
    sp = of(run)
    if sp is None or not sp.count.get("ga/chunk"):
        return None
    launches, _ = sp.call_totals(("cudaGraphLaunch",), ("ga/chunk",))
    return 1e3 * sp.host_s["ga/chunk"] / launches if launches else None
