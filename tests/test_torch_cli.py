"""The port's command line (`python -m starst3r_tpu_torch`) on the CPU, held
to the JAX package: its files are read by the JAX package (`points.ply`
by `io.ply.load_ply`, `scene.ckpt` by `Scene.load`), render-path's camera
path is the one the JAX `interp_se3_path` gives, and export-ply's colours
follow both SH rules. Tiny preset, 48 px, three images, GA 4 + 2, 3DGS 2
steps, ``--device cpu``, as tests/test_cli.py runs the JAX CLI (which is not
run here, to keep the time down).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

import starst3r_tpu as st

import starst3r_tpu_torch as stt
from starst3r_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECON = ["--res", "48", "--preset", "tiny", "--ga-iters1", "4",
         "--ga-iters2", "2", "--gs-iters", "2"]


@pytest.fixture(scope="module")
def imgdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    for i in range(3):
        arr = (rng.uniform(0, 255, size=(48, 48, 3))).astype(np.uint8)
        Image.fromarray(arr).save(d / f"im_{i}.png")
    return str(d)


@pytest.fixture(scope="module")
def recon(imgdir, tmp_path_factory):
    """One `reconstruct` run (images fed two, then one, through add_images;
    traced into a trace directory). Returns (out dir, the port's scene as
    it was saved, the trace directory)."""
    out = str(tmp_path_factory.mktemp("out"))
    trace = str(tmp_path_factory.mktemp("trace"))
    saved = []
    save = stt.Scene.save

    def keep(scene, path):
        saved.append(scene)
        return save(scene, path)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stt.Scene, "save", keep)
        # main sets STARST3R_TRACE_DIR; the context restores it
        mp.delenv("STARST3R_TRACE_DIR", raising=False)
        rc = cli.main(["--device", "cpu", "--trace-dir", trace,
                       "reconstruct", "--imgdir", imgdir, "--out", out,
                       "--incremental-batch", "2"] + RECON)
    assert rc == 0
    (scene,) = saved
    return out, scene, trace


def _scene_path(recon):
    return os.path.join(recon[0], "scene.ckpt")


def test_reconstruct_outputs(recon):
    out, scene, trace = recon
    for f in ("scene.ckpt", "points.ply", "c2w.npy", "intrinsics.npy",
              "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, f)), f
    assert scene.device.type == "cpu" and len(scene.imgs) == 3
    np.testing.assert_array_equal(np.load(os.path.join(out, "c2w.npy")),
                                  scene.c2w)
    np.testing.assert_array_equal(
        np.load(os.path.join(out, "intrinsics.npy")), scene.intrinsics)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    (load,) = [r for r in records if r["event"] == "load_images"]
    assert load["impl"] in ("native", "pil") and load["n_images"] == 3
    # --incremental-batch 2: add_images ran on 2 images, then on 3
    assert [r["n_images"] for r in records
            if r["event"] == "reconstruct"] == [2, 3]
    for label in ("inference", "ga", "splat_optim"):
        files = os.listdir(os.path.join(trace, label))
        assert any(f.endswith(".json") for f in files), (label, files)


def test_points_ply_read_by_jax(recon):
    out, scene, _ = recon
    pts, cols = st.io.ply.load_ply(os.path.join(out, "points.ply"))
    np.testing.assert_array_equal(pts, scene.dense_pts_flat.astype(
        np.float32))
    want = np.clip(scene.dense_cols_flat * 255.0 + 0.5, 0, 255).astype(
        np.uint8)
    np.testing.assert_array_equal(cols, want)


def test_scene_ckpt_read_by_jax(recon):
    _, scene, _ = recon
    back = st.Scene.load(_scene_path(recon))
    np.testing.assert_array_equal(back.c2w, scene.c2w)
    np.testing.assert_array_equal(back.intrinsics, scene.intrinsics)
    assert back.gs_state is not None and len(back.imgs) == 3
    np.testing.assert_array_equal(
        np.asarray(back.gs_state.params["means"]),
        scene.gs_state.params["means"].numpy())


def _jax_path(c2w, cameras, steps):
    """render-path's camera path built with the JAX `interp_se3_path`, as
    starst3r_tpu/cli.py builds it."""
    idxs = list(range(len(c2w))) if cameras is None else cameras
    keys = c2w[idxs]
    if len(keys) < 2:
        keys = np.concatenate([keys, keys], axis=0)
    nseg = max(1, len(keys) - 1)
    per_seg = max(2, -(-(steps - 1) // nseg) + 1)
    mats = []
    for a, b in zip(keys[:-1], keys[1:]):
        seg = np.asarray(st.interp_se3_path(a, b, steps=per_seg))
        mats.append(seg if not mats else seg[1:])
    return np.concatenate(mats, axis=0)


@pytest.mark.parametrize("cameras,steps", [(None, 4), ("2,0", 6), ("1", 3)])
def test_render_path_follows_jax_path(recon, tmp_path, cameras, steps):
    _, scene, _ = recon
    frames = str(tmp_path / "frames")
    args = ["--device", "cpu", "render-path", "--scene", _scene_path(recon),
            "--out", frames, "--steps", str(steps)]
    if cameras:
        args += ["--cameras", cameras]
    assert cli.main(args) == 0
    idxs = None if cameras is None else [int(c) for c in cameras.split(",")]
    path = cli.camera_path(scene.c2w, idxs, steps)
    want = _jax_path(scene.c2w, idxs, steps)
    assert path.shape == want.shape
    np.testing.assert_allclose(path, want, atol=1e-6)
    pngs = sorted(f for f in os.listdir(frames) if f.endswith(".png"))
    assert len(pngs) == len(path) >= steps
    im = np.asarray(Image.open(os.path.join(frames, pngs[0])))
    assert im.shape == scene.imgs[0].shape


@pytest.mark.parametrize("inverted", [True, False])
def test_export_ply_colors(recon, tmp_path, monkeypatch, inverted):
    """Both DC-colour rules: the compat inverted-SH init (1 - colour, the
    default config) and the standard one (colour - 0.5) / C0."""
    import dataclasses

    import starst3r_tpu_torch.scene as scene_mod
    cfg = stt.default_config()
    cfg = dataclasses.replace(cfg, splat=dataclasses.replace(
        cfg.splat, compat_inverted_sh=inverted))
    monkeypatch.setattr(scene_mod, "default_config", lambda: cfg)
    out = str(tmp_path / "g.ply")
    assert cli.main(["--device", "cpu", "export-ply", "--scene",
                     _scene_path(recon), "--out", out]) == 0
    pts, cols = st.io.ply.load_ply(out)
    jscene = st.Scene.load(_scene_path(recon))
    np.testing.assert_array_equal(
        pts, np.asarray(jscene.gs_state.params["means"]))
    sh0 = np.asarray(jscene.gs_state.params["sh0"][:, 0])
    rgb = (np.clip(1.0 - sh0, 0, 1) if inverted
           else np.clip(sh0 * 0.28209479177387814 + 0.5, 0, 1))
    np.testing.assert_array_equal(
        cols, np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8))


def test_train_gs(recon, tmp_path, capsys):
    out = str(tmp_path / "gs2")
    assert cli.main(["--device", "cpu", "train-gs", "--scene",
                     _scene_path(recon), "--out", out, "--iters", "2",
                     "--no-pruning"]) == 0
    line = capsys.readouterr().out
    first, last = (float(x) for x in re.search(
        r"loss (\S+) -> (\S+);", line).groups())
    assert np.isfinite(first) and np.isfinite(last)
    back = st.Scene.load(os.path.join(out, "scene.ckpt"))
    assert back.gs_state is not None


def test_reconstruct_rejects_too_few_images(tmp_path):
    d = tmp_path / "one"
    d.mkdir()
    Image.fromarray(np.zeros((48, 48, 3), np.uint8)).save(d / "x.png")
    assert cli.main(["--device", "cpu", "reconstruct", "--imgdir", str(d),
                     "--out", str(tmp_path / "o"), "--preset", "tiny"]) == 2


def test_info_prints_json(capsys):
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["version"] == stt.__version__
    assert info["torch"] == torch.__version__
    assert info["default_device"] == "cuda"
    assert info["devices"][0] == "cpu"


def test_cuda_default_without_gpu_raises(imgdir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["reconstruct", "--imgdir", imgdir, "--out",
                  str(tmp_path / "o")] + RECON)


def test_help_in_a_fresh_interpreter_loads_no_jax():
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, "-m", "starst3r_tpu_torch",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    for cmd in ("reconstruct", "train-gs", "render-path", "export-ply",
                "convert", "info"):
        assert cmd in out.stdout
    assert "bench" not in out.stdout
    code = ("import runpy, sys\n"
            "sys.argv = ['starst3r-torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('starst3r_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'starst3r_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
