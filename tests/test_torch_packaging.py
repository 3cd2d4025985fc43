"""Packaging guards for the PyTorch port `starst3r_tpu_torch`:

  1. no module of the port, nor of its Blender add-on
     (`blender_addon_torch/`, which reaches the port only through its
     command line), imports jax, flax, optax or starst3r_tpu (AST scan of
     every import, at any scope);
  2. importing the port in a fresh interpreter loads none of them (and
     not scipy, which `alignment/spectral.py` imports only to build a
     basis), and makes no torch.distributed process group (`parallel/`
     makes one only when asked);
  3. entry points default to the card: without a GPU they raise unless the
     caller passes device="cpu";
  4. the package data ships every file under `starst3r_tpu_torch/csrc/`
     (the kernels build from them at first use), and the `starst3r-torch`
     script names the port's command line.
"""

import ast
import fnmatch
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.alignment.ga import run_global_alignment
from starst3r_tpu_torch.alignment.lm import lm_refine
from starst3r_tpu_torch.alignment.schur import Tracks, schur_refine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "starst3r_tpu_torch")
ADDON = os.path.join(ROOT, "blender_addon_torch")
FORBIDDEN = ("jax", "flax", "optax", "starst3r_tpu")


def _forbidden(name: str) -> bool:
    # starst3r_tpu_torch itself starts with "starst3r_tpu": compare the
    # top-level package name, not the prefix
    return name.split(".")[0] in FORBIDDEN


def _py_files(roots=(PKG,)):
    for root in roots:
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(dirpath, f)


def test_forbidden_name_check_is_exact():
    assert _forbidden("starst3r_tpu.splat")
    assert _forbidden("jax.numpy")
    assert not _forbidden("starst3r_tpu_torch.splat")


def test_port_has_no_jax_or_reference_imports():
    files = list(_py_files((PKG, ADDON)))
    assert len(files) > 20
    assert os.path.join(ADDON, "command.py") in files
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                    and node.module and _forbidden(node.module):
                bad.append((path, node.module))
    assert bad == [], bad


PORT_MODULES = ("starst3r_tpu_torch", "starst3r_tpu_torch.splat",
                "starst3r_tpu_torch.utils.checkpoint",
                "starst3r_tpu_torch.io.torch_convert",
                "starst3r_tpu_torch.alignment.lm",
                "starst3r_tpu_torch.alignment.schur",
                "starst3r_tpu_torch.alignment.spectral",
                "starst3r_tpu_torch.cli", "starst3r_tpu_torch.native",
                "starst3r_tpu_torch.io.ply",
                "starst3r_tpu_torch.utils.synthetic",
                "starst3r_tpu_torch.utils.eval",
                "starst3r_tpu_torch.utils.profiling",
                "starst3r_tpu_torch.utils.compile_cache",
                "starst3r_tpu_torch.parallel",
                "starst3r_tpu_torch.parallel.comm",
                "starst3r_tpu_torch.parallel.distributed",
                "starst3r_tpu_torch.parallel.mesh",
                "starst3r_tpu_torch.parallel.tp",
                "starst3r_tpu_torch.version")


def test_import_port_loads_no_jax():
    code = (f"import sys, {', '.join(PORT_MODULES)}; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'starst3r_tpu', 'scipy')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_parallel_is_scanned_and_import_makes_no_process_group():
    files = {os.path.relpath(p, PKG) for p in _py_files()}
    assert {"parallel/__init__.py", "parallel/comm.py",
            "parallel/distributed.py", "parallel/mesh.py",
            "parallel/tp.py"} <= files
    code = (f"import {', '.join(PORT_MODULES)}; "
            "import torch.distributed as dist; "
            "print(dist.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_parallel_names_match_the_jax_package():
    with open(os.path.join(ROOT, "starst3r_tpu", "parallel",
                           "__init__.py")) as f:
        tree = ast.parse(f.read())
    names = {a.asname or a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names}
    import starst3r_tpu_torch.parallel as par
    assert len(names) >= 11
    assert names <= set(dir(par)), names - set(dir(par))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        stt.Scene()
    with pytest.raises(RuntimeError, match="cuda"):
        stt.Mast3rModel.init_random(stt.ModelConfig.tiny())
    with pytest.raises(RuntimeError, match="cuda"):
        stt.gs.init_gaussians(np.zeros((2, 3), np.float32),
                              np.zeros((2, 3), np.float32),
                              stt.SplatConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        run_global_alignment(None, (0, []), stt.GAConfig())
    z = np.zeros(1, np.int32)
    c2w = np.eye(4, dtype=np.float32)[None]
    one = np.ones(1, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        lm_refine(c2w, one, np.zeros((1, 2)), np.ones((1, 1)),
                  np.zeros((1, 2)), z, z, z, z, one)
    with pytest.raises(RuntimeError, match="cuda"):
        schur_refine(c2w, one, np.zeros((1, 2)), np.ones((1, 1)),
                     np.zeros((1, 2)), Tracks(z[None], z[None], one[None]))
    with pytest.raises(RuntimeError, match="cuda"):
        stt.Scene.load(os.path.join(ROOT, "no_such.ckpt"))
    with pytest.raises(RuntimeError, match="cuda"):
        stt.Mast3rModel.from_pretrained(os.path.join(ROOT, "no_such.npz"))
    scene = stt.Scene(device="cpu")
    assert scene.device.type == "cpu"


def _pyproject():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_package_data_ships_every_csrc_file():
    globs = _pyproject()["tool"]["setuptools"]["package-data"][
        "starst3r_tpu_torch"]
    files = sorted(os.listdir(os.path.join(PKG, "csrc")))
    assert {"composite_common.cuh", "starst3r_native.cpp"} <= set(files)
    missed = [f for f in files
              if not any(fnmatch.fnmatch(f"csrc/{f}", g) for g in globs)]
    assert missed == [], missed


def test_console_scripts_name_both_command_lines():
    scripts = _pyproject()["project"]["scripts"]
    assert scripts["starst3r-torch"] == "starst3r_tpu_torch.cli:main"
    assert scripts["starst3r"] == "starst3r_tpu.cli:main"
