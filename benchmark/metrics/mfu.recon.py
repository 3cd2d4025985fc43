"""The network's share of the card's bfloat16 peak over the window: the
operations of the pairs the finished scenes needed (the padding pairs of
a short last batch left out; `benchlib.work.network_flops`) over the
window's seconds times 989 TFLOP/s."""

from benchlib import device, work


def read(run):
    n = run.records.get("recon.scenes")
    hw = run.records.get("recon.image_hw")
    if not n or hw is None or not run.window_s:
        return None
    flops = n * run.records["recon.pairs"] * work.network_flops(
        run.cell.config, *hw)
    return 100.0 * flops / (run.window_s * device.PEAK_BF16)
