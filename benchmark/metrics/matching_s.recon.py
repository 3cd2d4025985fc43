"""Host seconds a scene in matching: the `recon/matching` span of
`reconstruct_scene` (each pair's descriptor matching and its copy to the
host), summed over the traced window and divided by its requests."""

from benchlib.spans import per_request_host_s


def read(run):
    return per_request_host_s(run, "recon/matching")
