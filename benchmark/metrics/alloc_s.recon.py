"""Host seconds a scene in the card's allocator: the `cudaMalloc` and
`cudaFree` runtime calls made inside the program's `imaging/`, `recon/`,
`net/` and `ga/` spans (the caching allocator growing or giving back its
pool), over the traced window's requests."""

from benchlib.spans import of

LAYERS = ("imaging/", "recon/", "net/", "ga/")


def read(run):
    sp = of(run)
    if sp is None or not sp.requests or not sp.device_events or not any(
            n.startswith(LAYERS) for n in sp.count):
        return None
    _, s = sp.call_totals(("cudaMalloc", "cudaFree"), LAYERS)
    return s / sp.requests
