"""Session set-up shared by every test directory, loaded before
`tests/conftest.py`.

The JAX package's C++ host library is built once, under a file lock,
before any test module is imported. Under `pytest -n N` every worker
imports every test file, and `tests/test_native.py` asks for that library
at import; `starst3r_tpu.native.build` writes g++'s output straight to the
library's path, so a worker could load a half-written file and keep the
failure for its session. The first worker to take the lock builds; the
others wait and then find the library complete. The module is loaded from
its file, so no JAX is imported here. (The port's `native` builds into a
temporary file and renames it, and needs no lock.)
"""

import fcntl
import importlib.util
import os

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "starst3r_tpu", "native", "__init__.py")


def _build_native_library():
    spec = importlib.util.spec_from_file_location("_starst3r_native_build",
                                                  _NATIVE)
    native = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native)
    os.makedirs(native._LIB_DIR, exist_ok=True)
    with open(os.path.join(native._LIB_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            native.build()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


if os.path.exists(_NATIVE):
    _build_native_library()
