"""Binary PLY point clouds (port of `starst3r_tpu/io/ply.py`): the files
the CLI writes and the Blender add-on reads. The bytes on disk are the JAX
package's, so each package reads the other's files."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ("save_ply", "load_ply")


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """points: (N, 3) float; colors: optional (N, 3) float in [0, 1] or
    uint8."""
    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    has_color = colors is not None
    if has_color:
        cols = np.asarray(colors)
        if cols.dtype != np.uint8:
            cols = np.clip(cols * 255.0 + 0.5, 0, 255).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols
            f.write(rec.tobytes())
        else:
            f.write(pts.tobytes())


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a file written by `save_ply` (of either package): (points
    (N, 3) float32, colours (N, 3) uint8 or None)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = 0
        has_color = False
        for line in header:
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if "uchar red" in line:
                has_color = True
        if has_color:
            rec = np.frombuffer(
                f.read(n * (12 + 3)),
                dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.frombuffer(f.read(n * 12), dtype=np.float32).reshape(n, 3)
        return pts.copy(), None
