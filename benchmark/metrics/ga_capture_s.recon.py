"""Host seconds a scene preparing the alignment's phases on the card: the
`ga/capture` spans of `_optimize_phase` (each phase's state, its three
eager warm-up steps and the capture of one step as a CUDA graph), over
the traced window's requests."""

from benchlib.spans import per_request_host_s


def read(run):
    return per_request_host_s(run, "ga/capture")
