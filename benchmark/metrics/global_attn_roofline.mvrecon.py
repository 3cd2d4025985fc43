"""The global attention's share of its roofline: the least time its
counted work needs at the bfloat16 peak (`benchlib.vggt_work`: the depth
times 4 T^2 C, T = S x P tokens of a scene, at 989 TFLOP/s; bound by
operations, its bytes are T C a tensor) over the device time a scene of
the kernels launched in the program's `vggt/global_attn` span, in
percent."""

from benchlib import device, vggt_work
from benchlib.spans import per_request_device_s


def read(run):
    hw = run.records.get("mvrecon.image_hw")
    s = per_request_device_s(run, "vggt/global_attn")
    if hw is None or not s:
        return None
    flops = vggt_work.vggt_flops(run.cell.config,
                                 run.records["mvrecon.views"],
                                 *hw)["global_attn"]
    return 100.0 * flops / device.PEAK_BF16 / s
