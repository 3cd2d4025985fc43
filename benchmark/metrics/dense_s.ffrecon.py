"""Host seconds a scene in the program's `recon/dense` span: the copy of
the depths, cameras and confidences to the card, the unprojection's
launches, and the copy of every view's dense points, depths and
confidences back to the host, which waits for it; summed over the traced
window and divided by its requests."""

from benchlib.spans import per_request_host_s


def read(run):
    return per_request_host_s(run, "recon/dense")
