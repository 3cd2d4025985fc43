"""The compositing backward's entry (`composite_packed_bwd_cuda`: K2, the
row order `packed_csr`, the row sum G1) on the window's last step's
inputs: least time over device time, in percent."""

from benchlib.readers import bwd_roofline


def read(run):
    return bwd_roofline(run)
