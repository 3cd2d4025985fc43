"""The fusion attention's share of its roofline: the least time its
counted work needs at the bfloat16 peak (`benchlib.fast3r_work`: the
fusion depth times 4 T^2 C, T = N x P tokens of a scene, at 989 TFLOP/s;
bound by operations) over the device time a scene of the kernels launched
in the program's `fast3r/fuse_attn` span (the q and k rotation and the
attention), in percent."""

from benchlib import device, fast3r_work
from benchlib.spans import per_request_device_s


def read(run):
    hw = run.records.get("ffrecon.image_hw")
    s = per_request_device_s(run, "fast3r/fuse_attn")
    if hw is None or not s:
        return None
    flops = fast3r_work.fast3r_flops(run.cell.config,
                                     run.records["ffrecon.views"],
                                     *hw)["fuse_attn"]
    return 100.0 * flops / device.PEAK_BF16 / s
