"""Device milliseconds a pair in the network's `net/encode` span: the
kernels launched inside it (found by their correlation ids, wherever they
ran), over the pairs the scenes needed (the padding of a batch counts
as cost), in the traced window."""

from benchlib.spans import network_ms_per_pair


def read(run):
    return network_ms_per_pair(run, "net/encode")
