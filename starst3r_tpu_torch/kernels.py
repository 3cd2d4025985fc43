"""Build and load the port's CUDA kernels (`starst3r_tpu_torch/csrc/*.cu`).

Each source is compiled on first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -shared`` into `starst3r_tpu_torch/_build/`,
or the directory `utils.enable_compilation_cache` chose (the file name
carries a hash of the source and of the shared headers, so an edited
source builds anew; `ga_loss.cu` and `ga_step.cu` add ``-fmad=false``)
and loaded with ctypes. Each exports C functions (one named after its
file, or ``gather_rows_bwd_split``, or `ga_step.cu`'s ``ga_reparam`` and
``ga_update``; the compositing sources also a ``_packed`` route) that
launch a kernel on the stream they are given and return the CUDA error
code; `launch` raises on a non-zero code. `build` compiles several
sources at once, one `nvcc` each, all started together. `build` and
`library` also take another directory of the same sources (another
revision of `csrc/`), which chip_smoke.py uses to time a parent commit's
kernels beside these with the same nvcc line.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

from .utils.compile_cache import build_dir

__all__ = ("KERNELS", "build", "launch", "library")

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"

_P, _I = ctypes.c_void_p, ctypes.c_int
# source file (csrc/<name>.cu) -> {exported function: its argument types}.
# Another revision's source may lack a function (a parent commit's has no
# packed routes); the existing names keep their argument lists.
_EXPORTS = {
    "composite_fwd": {"composite_fwd": [_P] * 6 + [_I] * 7 + [_P],
                      "composite_fwd_packed": [_P] * 7 + [_I] * 7 + [_P]},
    "composite_bwd": {"composite_bwd": [_P] * 8 + [_I] * 7 + [_P],
                      "composite_bwd_packed": [_P] * 9 + [_I] * 7 + [_P]},
    "gather_entries": {"gather_entries": [_P] * 4 + [ctypes.c_int64, _P]},
    # gather_rows_bwd is an earlier revision's launcher (one block a row,
    # its shape chosen in C), which this revision's source no longer has
    "gather_rows_bwd": {"gather_rows_bwd": [_P] * 4 + [_I] * 3 + [_P],
                        "gather_rows_bwd_split": [_P] * 4 + [_I] * 7 + [_P]},
    "ga_loss": {"ga_loss": [_P] * 10 + [_I] * 8 + [ctypes.c_float] * 5
                + [_P]},
    "ga_step": {"ga_reparam": [_P] * 5 + [_I] * 5 + [_P],
                "ga_update": [_P] * 6 + [_I] * 6 + [ctypes.c_float] * 8
                + [_P]},
    "rope_attention": {"rope_attention": [_P] * 8 + [_I] * 6
                       + [ctypes.c_int64] * 9 + [ctypes.c_float, _P]},
}
# nvcc flags of one source beyond the common line: the GA's fused loss and
# its step round every product and sum on their own (no contraction into
# FMAs), as the PyTorch ops of their plain versions round them
_FLAGS = {"ga_loss": ("-fmad=false",), "ga_step": ("-fmad=false",)}
KERNELS = tuple(_EXPORTS)
_SOURCE_OF = {fn: name for name, fns in _EXPORTS.items() for fn in fns}


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on first use and need the CUDA toolkit")


def _so_path(name: str, csrc: Path = _CSRC) -> Path:
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    if name in _FLAGS:
        digest.update(" ".join(_FLAGS[name]).encode())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    return build_dir() / f"{name}_{digest.hexdigest()[:16]}.so"


def _compile(name: str, csrc: Path = _CSRC) -> Tuple[float, str]:
    """nvcc one source into its library. Returns (seconds, compiler log)."""
    so = _so_path(name, csrc)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", *_FLAGS.get(name, ()), "-I", str(csrc),
           "-o", str(tmp),
           str(csrc / f"{name}.cu")]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    secs = time.perf_counter() - t
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):"
                           f"\n{log}")
    os.replace(tmp, so)
    return secs, log


def build(names: Optional[Iterable[str]] = None, csrc: Path = _CSRC
          ) -> Dict[str, Tuple[float, str]]:
    """Build the named kernels (all by default) from the sources in
    ``csrc`` that are not on disk yet, one nvcc each, in parallel. Returns
    {name: (seconds, compiler log)} for the sources compiled now."""
    csrc = Path(csrc)
    todo = [n for n in (names or KERNELS) if not _so_path(n, csrc).exists()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        return dict(zip(todo, pool.map(lambda n: _compile(n, csrc), todo)))


def library(name: str, csrc: Path = _CSRC) -> ctypes.CDLL:
    """The loaded library of source ``name`` built from the sources in
    ``csrc``, built first if need be (into the current `build_dir`), with
    the argument types of the functions it exports set."""
    return _library(name, Path(csrc), build_dir())


@functools.lru_cache(maxsize=None)
def _library(name: str, csrc: Path, where: Path) -> ctypes.CDLL:
    # ``where`` is the build directory, so each directory loads its own
    if name not in _EXPORTS:
        raise KeyError(f"no CUDA kernel source named {name!r}")
    so = _so_path(name, csrc)
    if not so.exists():
        build([name], csrc)
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in _EXPORTS[name].items():
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def launch(fn_name: str, *args) -> None:
    """Call the exported launcher ``fn_name``; raise if CUDA refused the
    launch."""
    err = getattr(library(_SOURCE_OF[fn_name]), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
