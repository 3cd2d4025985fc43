"""Host seconds a scene loading its photos: the program's `imaging/load`
span (`load_images` in VGGT's crop mode: decoding the PNGs and the
resize), summed over the traced window and divided by its requests."""

from benchlib.spans import per_request_host_s


def read(run):
    return per_request_host_s(run, "imaging/load")
