"""Seconds a scene in pair inference (`models/`, 30 pairs at 8 a
forward): the `inference` stage of `reconstruct_scene`'s own timer, which
ends in a device synchronise."""


def read(run):
    inf = run.records.get("recon.inference_s")
    return sum(inf) / len(inf) if inf else None
