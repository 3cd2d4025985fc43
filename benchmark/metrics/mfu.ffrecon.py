"""The network's share of the card's bfloat16 peak over the window: the
operations of one Fast3R forward over a scene's views
(`benchlib.fast3r_work.fast3r_flops`) times the finished scenes, over the
window's seconds times 989 TFLOP/s."""

from benchlib import device, fast3r_work


def read(run):
    n = run.records.get("ffrecon.scenes")
    hw = run.records.get("ffrecon.image_hw")
    if not n or hw is None or not run.window_s:
        return None
    flops = fast3r_work.fast3r_flops(run.cell.config,
                                     run.records["ffrecon.views"],
                                     *hw)["total"]
    return 100.0 * n * flops / (run.window_s * device.PEAK_BF16)
