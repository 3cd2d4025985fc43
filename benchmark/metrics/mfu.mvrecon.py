"""The network's share of the card's bfloat16 peak over the window: the
operations of one VGGT forward over a scene's views
(`benchlib.vggt_work.vggt_flops`) times the finished scenes, over the
window's seconds times 989 TFLOP/s."""

from benchlib import device, vggt_work


def read(run):
    n = run.records.get("mvrecon.scenes")
    hw = run.records.get("mvrecon.image_hw")
    if not n or hw is None or not run.window_s:
        return None
    flops = vggt_work.vggt_flops(run.cell.config,
                                 run.records["mvrecon.views"], *hw)["total"]
    return 100.0 * n * flops / (run.window_s * device.PEAK_BF16)
