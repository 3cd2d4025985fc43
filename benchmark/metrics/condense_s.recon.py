"""Host seconds a scene between matching and the alignment: the
`recon/condense` span of `reconstruct_scene` (the canonical views, the
spanning tree and the condensed correspondences), over the traced
window's requests."""

from benchlib.spans import per_request_host_s


def read(run):
    return per_request_host_s(run, "recon/condense")
