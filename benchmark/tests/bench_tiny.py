"""Tiny cells of each traffic kind that run on the CPU."""

import json
import time

from conftest import BENCH


def tiny_config() -> dict:
    """The 224 configuration at the program's tiny widths, float32."""
    with open(BENCH / "configs" / "mast3r-vitl-224.json") as f:
        c = json.load(f)
    c.update(name="tiny", enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
             dec_embed_dim=48, dec_depth=2, dec_num_heads=2,
             local_feat_dim=8, dpt_feature_dim=32,
             dpt_layer_dims=[8, 12, 16, 24], dpt_last_dim=16, image_size=64,
             dtype="float32")
    # a refine every 8 steps, past the three steps the check follows
    c["splat"] = dict(c["splat"], mcmc_refine_every=8, mcmc_refine_start=8)
    return c


def tiny_traffic(kind: str) -> dict:
    with open(BENCH / "traffic" / f"{kind}.json") as f:
        t = json.load(f)
    if kind == "recon":
        t.update(views=3, photo_hw=[48, 64], points=400, max_scenes_per_s=6)
        t["ga"].update(niter1=20, niter2=10)
    else:
        t.update(image_hw=[32, 48])
        t["scene"]["cameras"] = 3
        if kind == "train":
            t.update(chunk=8)
        else:
            t.update(train_steps=3, views=8,
                     check={"first": 8, "requests": 2})
    return t


E2E = {"recon": "recon_s", "train": "train_step_ms",
       "render": "render_ms_p95"}
# the cell whose limits a tiny cell of each kind is held to
LIMITS_OF = {"recon": "vitl224-recon", "train": "vitl512-train",
             "render": "vitl512-render"}


def tiny_checks(kind: str) -> dict:
    with open(BENCH / "checks" / f"{LIMITS_OF[kind]}.json") as f:
        return json.load(f)


def tiny_run(kind: str, seed: int = 5, seconds: float = 1.0,
             trace: bool = False, per_layer=(), traffic=None):
    """A `Run` of a tiny cell of ``kind`` on the CPU (``traffic``: another
    traffic dict)."""
    from benchlib.manifest import Cell
    from benchlib.runner import Run
    cell = Cell(f"tiny.{kind}", "tiny", kind, 1, tiny_config(),
                traffic or tiny_traffic(kind),
                [{"name": E2E[kind], "unit": "x"},
                 {"name": "setup_s", "unit": "s"}], list(per_layer),
                tiny_checks(kind))
    return Run(cell, seed, seconds, trace, "cpu")


def run_tiny(kind: str, **kw) -> dict:
    from benchlib.runner import run_cell
    return run_cell(tiny_run(kind, **kw), time.perf_counter())
