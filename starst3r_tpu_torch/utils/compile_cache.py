"""Where the port builds what it compiles at first use: the counterpart of
the JAX package's persistent compilation cache (`utils/jaxcache.py`).

The JAX package caches XLA executables on disk. The port compiles its CUDA
kernels (`kernels.py`, nvcc) and its C++ host library (`native/`,
g++) at first use into `starst3r_tpu_torch/_build/`; the file names carry a
hash of their sources, so a directory holds the builds of every revision
and is reused across processes. `enable_compilation_cache(path)` moves
later builds and loads to ``path`` (created when missing). Without a call
nothing changes. ``STARST3R_NO_COMPILE_CACHE=1`` makes the call a no-op, as
in the JAX package.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

__all__ = ("build_dir", "enable_compilation_cache")

_DEFAULT_DIR = Path(__file__).resolve().parent.parent / "_build"
# the directory `enable_compilation_cache` chose, or None for the default
_dir: Optional[Path] = None


def build_dir(default: Path = _DEFAULT_DIR) -> Path:
    """The directory builds go to and load from now: the one
    `enable_compilation_cache` chose, else ``default``."""
    return _dir or default


def enable_compilation_cache(path: Union[str, os.PathLike, None] = None
                             ) -> None:
    """Build and load the kernels and the native library under ``path``
    from now on (None: the default `starst3r_tpu_torch/_build/`). A no-op
    when ``STARST3R_NO_COMPILE_CACHE`` is "1"."""
    global _dir
    if os.environ.get("STARST3R_NO_COMPILE_CACHE") == "1":
        return
    chosen = Path(path).resolve() if path is not None else None
    (chosen or _DEFAULT_DIR).mkdir(parents=True, exist_ok=True)
    _dir = chosen
