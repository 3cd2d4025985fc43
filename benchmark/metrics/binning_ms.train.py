"""Stream milliseconds a training step in the binning (projection, the
sort, the tile lists, the budget check): the program's own `3dgs/binning`
CUDA events (`splat.train.stage_events`), summed over the window's steps
and divided by them."""


from benchlib.readers import stage_ms


def read(run):
    return stage_ms(run, "binning")
