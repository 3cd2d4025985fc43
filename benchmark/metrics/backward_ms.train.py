"""Stream milliseconds a training step in the backward (SSIM's, K2, the
row order and G1, the projection's): the program's own `3dgs/backward`
CUDA events, per step of the window."""


from benchlib.readers import stage_ms


def read(run):
    return stage_ms(run, "backward")
