"""Host seconds a scene loading its photos: the program's `imaging/load`
span (`load_images` as MASt3R's: decoding the PNGs, the resize and crop),
summed over the traced window and divided by its requests."""

from benchlib.spans import per_request_host_s


def read(run):
    return per_request_host_s(run, "imaging/load")
