"""ctypes bindings and build glue for the C++ host runtime (port of
`starst3r_tpu/native/__init__.py`).

The host runtime around the device path: image preprocessing (bicubic
resize, centre crop, normalisation) on one image or a thread pool, content
hashing and float-to-uint8 conversion. The source is the port's own copy,
`starst3r_tpu_torch/csrc/starst3r_native.cpp`; it is compiled with ``g++``
on first use into `starst3r_tpu_torch/_build/`, or the directory
`utils.enable_compilation_cache` chose (the file name carries a hash of the
source, so an edited source builds anew), and loaded with ctypes.
This is host C++: no CUDA.

`available()` builds on first call and says whether the library loaded.
The other functions raise RuntimeError when it cannot be built; callers that
want the pure-Python route ask for it (`imaging.load_images(impl="pil")`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.compile_cache import build_dir as _cache_dir

__all__ = ("available", "build", "output_shape", "preprocess",
           "preprocess_batch", "hash64", "rgb_to_u8")

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "starst3r_native.cpp"
_BUILD_DIR = _PKG / "_build"

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int)


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _cache_dir(_BUILD_DIR) / f"libstarst3r_native_{digest}.so"


def _build(force: bool = False) -> Optional[str]:
    """Compile the library unless it is on disk or ``force`` (the JAX
    package's g++ line). Returns None on success, else the reason it
    failed."""
    if not _SRC.exists():
        return f"{_SRC} is missing"
    so = _lib_path()
    if so.exists() and not force:
        return None
    cxx = shutil.which("g++")
    if cxx is None:
        return "g++ is not on the PATH"
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-o", str(tmp), str(_SRC), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120, check=False)
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ did not run: {e}"
    if proc.returncode != 0 or not tmp.exists():
        return f"g++ failed ({proc.returncode}):\n{proc.stderr}"
    os.replace(tmp, so)
    return None


def build(force: bool = False) -> bool:
    """Compile the shared library if it is not built yet; with ``force``,
    compile it anew even when it is, and drop this process's kept outcome
    of loading it. Returns success."""
    ok = _build(force) is None
    if force:
        _load.cache_clear()
    return ok


@functools.lru_cache(maxsize=None)
def _load(path: Path) -> Tuple[Optional[ctypes.CDLL], str]:
    """(the library at ``path``, `_lib_path()`, loaded with its argument
    types set, or None; why not). Built on the first call; the outcome is
    kept for the process, per path."""
    why = _build()
    if why is not None:
        return None, why
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        return None, f"loading the library failed: {e}"
    lib.st_preprocess_shape.argtypes = [ctypes.c_int] * 4 + [_I32P, _I32P]
    lib.st_preprocess_shape.restype = ctypes.c_int
    lib.st_preprocess.argtypes = [_U8P] + [ctypes.c_int] * 4 + \
        [ctypes.c_float, ctypes.c_float, _F32P]
    lib.st_preprocess.restype = ctypes.c_int
    lib.st_preprocess_batch.argtypes = [
        ctypes.POINTER(_U8P), _I32P, _I32P, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(_F32P), ctypes.c_int]
    lib.st_preprocess_batch.restype = ctypes.c_int
    lib.st_hash64.argtypes = [_U8P, ctypes.c_uint64, ctypes.c_uint64]
    lib.st_hash64.restype = ctypes.c_uint64
    lib.st_rgb_to_u8.argtypes = [_F32P, ctypes.c_int, _U8P]
    lib.st_rgb_to_u8.restype = None
    return lib, ""


def available() -> bool:
    """Whether the library builds and loads here (built on first call)."""
    return _load(_lib_path())[0] is not None


def _library() -> ctypes.CDLL:
    lib, why = _load(_lib_path())
    if lib is None:
        raise RuntimeError(f"the native library is unavailable: {why}")
    return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _rgb_u8(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    return img


def output_shape(h: int, w: int, size: int, crop_mult: int
                 ) -> Tuple[int, int]:
    """(H', W') of an h x w image after `preprocess`."""
    oh, ow = ctypes.c_int(), ctypes.c_int()
    rc = _library().st_preprocess_shape(h, w, size, crop_mult,
                                        ctypes.byref(oh), ctypes.byref(ow))
    if rc != 0:
        raise ValueError(f"image {h}x{w} too small for size={size}, "
                         f"crop_mult={crop_mult}")
    return oh.value, ow.value


def preprocess(img: np.ndarray, size: int, crop_mult: int = 16,
               mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """HWC uint8 RGB -> (3, H', W') float32 normalised."""
    lib = _library()
    img = _rgb_u8(img)
    h, w = img.shape[:2]
    oh, ow = output_shape(h, w, size, crop_mult)
    out = np.empty((3, oh, ow), np.float32)
    if lib.st_preprocess(_u8ptr(img), h, w, size, crop_mult, mean, std,
                         _f32ptr(out)) != 0:
        raise ValueError("preprocess failed")
    return out


def preprocess_batch(imgs: Sequence[np.ndarray], size: int,
                     crop_mult: int = 16, mean: float = 0.5,
                     std: float = 0.5,
                     n_threads: int = 0) -> List[np.ndarray]:
    """`preprocess` over a list of images on a thread pool (0 threads: one
    per core)."""
    lib = _library()
    imgs = [_rgb_u8(im) for im in imgs]
    n = len(imgs)
    hs = np.array([im.shape[0] for im in imgs], np.int32)
    ws = np.array([im.shape[1] for im in imgs], np.int32)
    outs = [np.empty((3,) + output_shape(im.shape[0], im.shape[1], size,
                                         crop_mult), np.float32)
            for im in imgs]
    # the pointer arrays hold raw addresses: imgs and outs stay referenced
    # until the call returns
    img_ptrs = (_U8P * n)(*[_u8ptr(im) for im in imgs])
    out_ptrs = (_F32P * n)(*[_f32ptr(o) for o in outs])
    fails = lib.st_preprocess_batch(
        img_ptrs, hs.ctypes.data_as(_I32P), ws.ctypes.data_as(_I32P), n,
        size, crop_mult, mean, std, out_ptrs, n_threads)
    if fails:
        raise ValueError(f"{fails} images failed preprocessing")
    return outs


def hash64(data: Union[bytes, np.ndarray], seed: int = 0) -> int:
    """64-bit content hash of a buffer."""
    lib = _library()
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return int(lib.st_hash64(ctypes.cast(buf, _U8P), len(data), seed))


def rgb_to_u8(rgb: np.ndarray) -> np.ndarray:
    """float RGB in [0, 1] -> uint8, elementwise (any shape)."""
    lib = _library()
    rgb = np.ascontiguousarray(rgb, np.float32)
    out = np.empty(rgb.shape, np.uint8)
    lib.st_rgb_to_u8(_f32ptr(rgb), rgb.size, _u8ptr(out))
    return out
