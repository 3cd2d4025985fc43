"""The fusion's q and k rotation's share of its roofline: the least time
its bytes need at the card's memory bandwidth (`benchlib.fast3r_work.
rotate_bytes`: q and k read and their rotation written once, in
bfloat16, and the cos and sin tables read once, a fusion call; at 3.35
TB/s) over the device time a scene of the kernels launched in the
program's `attn/rotate` span (`ops/attention.py::rope_attention`'s
rotation of q and k once a call), in percent."""

from benchlib import device, fast3r_work
from benchlib.spans import per_request_device_s


def read(run):
    hw = run.records.get("ffrecon.image_hw")
    s = per_request_device_s(run, "attn/rotate")
    if hw is None or not s:
        return None
    bytes_ = fast3r_work.rotate_bytes(run.cell.config,
                                      run.records["ffrecon.views"], *hw)
    return 100.0 * bytes_ / device.PEAK_BYTES / s
