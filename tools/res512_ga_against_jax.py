#!/usr/bin/env python3
"""The port's GA at chip_smoke.py's `[res512]` operating point held to the
JAX package's on the same inputs, and the JAX GA held to itself.

    python3 chip_smoke.py --res512-record OUT.pkl     # on the card
    python tools/res512_ga_against_jax.py OUT.pkl      # on the CPU

`chip_smoke.py --res512-record` writes each of `[res512]`'s two GA calls'
inputs (condensed data, MST, GAConfig, warm start) and the card's result.
This script runs the JAX package's GA and the port's on the CPU on each
call's inputs and prints, for the card, JAX and the port on the CPU, the
principal points, focals and losses, and the poses' largest distance from
the JAX package's in camera 0's frame. Then it reruns the JAX GA with its
inputs moved by 1e-7 relative (the warm start's translations where the
call has a warm start, else the condensed core depths) and prints how far
its poses move from its own: a float32 comparison with the JAX package is
only as tight as that spread.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PERTURB = 1e-7


def in_cam0(c2w):
    c2w = np.asarray(c2w, np.float64)
    return np.linalg.inv(c2w[0])[None] @ c2w


def pose_gap(a, b):
    return float(np.abs(in_cam0(a) - in_cam0(b)).max())


def main(path):
    import pickle

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    from starst3r_tpu.alignment import ga as jga
    from starst3r_tpu.alignment.condense import CondensedData as JData
    from starst3r_tpu.config import GAConfig as JConfig
    from starst3r_tpu_torch.alignment import ga as tga
    from starst3r_tpu_torch.alignment.condense import CondensedData as TData
    from starst3r_tpu_torch.config import GAConfig as TConfig

    torch.set_num_threads(4)
    with open(path, "rb") as f:
        calls = pickle.load(f)
    scale = np.float32(1 + PERTURB)
    for k, call in enumerate(calls):
        data, prev, cfg = call["data"], call["prev"], call["cfg"]

        def run_jax(data, prev):
            r, _ = jga.run_global_alignment(
                JData(**data), call["mst"], JConfig(**cfg),
                prev_params=None if prev is None
                else jga.GAParams(*[jnp.asarray(p) for p in prev]))
            return (np.asarray(r.K), (r.loss_coarse, r.loss_fine),
                    np.asarray(r.cam2w))

        rt, _ = tga.run_global_alignment(
            TData(**data), call["mst"], TConfig(**cfg),
            prev_params=None if prev is None
            else tga.GAParams(*[torch.from_numpy(p) for p in prev]),
            device="cpu")
        runs = {"card": (call["K"], call["losses"], call["cam2w"]),
                "jax": run_jax(data, prev),
                "port-cpu": (rt.K.numpy(), (rt.loss_coarse, rt.loss_fine),
                             rt.cam2w.numpy())}
        if prev is None:
            moved = "core depths"
            data_m, prev_m = dict(data, core_depth=data["core_depth"] * scale), prev
        else:
            moved = "warm start's translations"
            data_m = data
            prev_m = list(prev)
            prev_m[jga.GAParams._fields.index("trans")] = (
                prev[jga.GAParams._fields.index("trans")] * scale)
        runs[f"jax, {moved} x (1 + {PERTURB:g})"] = run_jax(data_m, prev_m)
        print(f"call {k}: {len(data['imsizes'])} cameras of "
              f"{data['imsizes'][0]}, S {data['core_pix'].shape[0]}, M "
              f"{data['corr_img1'].shape[0]}", flush=True)
        for name, (K, losses, c2w) in runs.items():
            print(f"  {name}: pp {np.round(K[:, :2, 2], 2).tolist()} focal "
                  f"{np.round(K[:, 0, 0], 1).tolist()} losses {losses}; "
                  f"poses from jax's {pose_gap(c2w, runs['jax'][2]):.3g}",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
