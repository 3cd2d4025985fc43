"""Content-addressed on-disk cache for pairwise inference results.

The reference caches per-pair predictions as .pth files keyed by fake
filenames under a tmpdir (reference: starster/scene.py:60-62,118-120,
reconstruct.py:54-55,97-99). Here the cache key is a content hash of
(model tag, image bytes, pair direction, resolution) — no fake filelists,
re-runs skip completed pairs regardless of call order (SURVEY §7.5).
Each entry is written to a temporary name of the writing process and then
renamed over its final name, so a reader never sees half a file.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np

__all__ = ("PairCache", "content_key")


def content_key(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(str(p).encode())
        h.update(b"\x00")
    return h.hexdigest()[:32]


class PairCache:
    def __init__(self, cache_dir: Optional[str]):
        self.dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"pair_{key}.npz")

    def get(self, key: str) -> Optional[dict]:
        if not self.dir:
            return None
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with np.load(path, allow_pickle=False) as data:
            return {k: data[k] for k in data.files}

    def put(self, key: str, arrays: dict) -> None:
        if not self.dir:
            return
        path = self._path(key)
        # a temporary name of this process's own, so two processes writing
        # one key never share it; np.savez appends ".npz" unless the name
        # already ends with it
        tmp = f"{path[:-4]}.tmp{os.getpid()}.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
