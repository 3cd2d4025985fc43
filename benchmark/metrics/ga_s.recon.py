"""Seconds a scene in the global alignment (`alignment/ga.py`): the `ga`
stage of `reconstruct_scene`'s own timer, read through its logger. The
stage starts after condensation's host work and ends in the host copy of
the poses, so it holds the device's work."""


def read(run):
    ga = run.records.get("recon.ga_s")
    return sum(ga) / len(ga) if ga else None
