"""Device idle share of the Fast3R reconstruction window: 100 (1 - busy /
window), busy the union of the device's kernels, copies and sets in the
profiler's trace of the whole window."""

from benchlib.readers import idle_share


def read(run):
    return idle_share(run)
