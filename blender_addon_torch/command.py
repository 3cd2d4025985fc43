"""The add-on's work outside Blender: the reconstruction command built from
the panel's values, the checks made before running it, and the reading of
its output directory. No bpy here, so it runs (and is tested) anywhere.

The command is the port's command line with the JAX add-on's flags
(`blender_addon/interface.py`) plus the port's ``--device``, which comes
before the subcommand:

    <python> -m starst3r_tpu_torch --device <cuda|cpu> reconstruct
        --imgdir <dir> --out <dir> --res <n> --preset <name> [--model <npz>]
"""

import os
import subprocess

import numpy as np

PRESETS = ("tiny", "small", "base", "large")
DEVICES = ("cuda", "cpu")
IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def build_command(python, directory, out, resolution, preset, device,
                  model=""):
    """argv of the reconstruction subprocess (paths as given: the caller
    resolves Blender's relative ones)."""
    if preset not in PRESETS:
        raise ValueError(f"preset must be one of {PRESETS}, not {preset!r}")
    if device not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, not {device!r}")
    cmd = [python, "-m", "starst3r_tpu_torch", "--device", device,
           "reconstruct", "--imgdir", directory, "--out", out,
           "--res", str(int(resolution)), "--preset", preset]
    if model:
        cmd += ["--model", model]
    return cmd


def verify(directory, model=""):
    """Why the reconstruction cannot start (a message for the user), or
    None: the image directory must exist and hold two or more jpg/png
    images, and a model path, when given, must be a file."""
    if not directory or not os.path.isdir(directory):
        return "image directory does not exist"
    imgs = [f for f in os.listdir(directory)
            if f.lower().endswith(IMAGE_EXTS)]
    if len(imgs) < 2:
        return "need at least two jpg/png images"
    if model and not os.path.isfile(model):
        return "model checkpoint not found"
    return None


def run(cmd, timeout=3600):
    """Run the command; the CompletedProcess (its output captured)."""
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, check=False)


def load_ply(path):
    """(points (N, 3) float32, colours (N, 3) float32 in [0, 1] or None) of
    a binary PLY as the port's `io/ply.py::save_ply` writes it."""
    with open(path, "rb") as f:
        n = 0
        has_color = False
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if "uchar red" in line:
                has_color = True
            if line == "end_header":
                break
        if has_color:
            rec = np.frombuffer(f.read(n * 15),
                                dtype=[("xyz", np.float32, 3),
                                       ("rgb", np.uint8, 3)])
            return rec["xyz"].copy(), rec["rgb"].astype(np.float32) / 255.0
        pts = np.frombuffer(f.read(n * 12), np.float32).reshape(n, 3)
        return pts.copy(), None


def read_result(out_dir):
    """(points (N, 3), colours (N, 3) or None, c2w (C, 4, 4) or None) of a
    reconstruction's output directory: points.ply and c2w.npy."""
    pts, cols = load_ply(os.path.join(out_dir, "points.ply"))
    path = os.path.join(out_dir, "c2w.npy")
    c2w = np.load(path) if os.path.exists(path) else None
    return pts, cols, c2w
