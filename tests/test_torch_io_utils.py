"""The port's I/O and utility modules against the JAX package's, on the CPU:
PLY files (the same bytes), the native host runtime (the same outputs bit
for bit), the image routes of `load_images`, `image_to_uint8`, the camera,
SE(3) and schedule helpers (within 1e-6), the planted scenes of
`utils.synthetic` (bit for bit), the trajectory metrics of `utils.eval`
(equal), `utils.profiling.trace_if`, and the two examples at a small size.
"""

import filecmp
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

import jax.numpy as jnp

import starst3r_tpu as st
from starst3r_tpu import native as jnative
from starst3r_tpu.io import ply as jply
from starst3r_tpu.utils import camera as jcam
from starst3r_tpu.utils import eval as jeval
from starst3r_tpu.utils import schedules as jsched
from starst3r_tpu.utils import se3 as jse3
from starst3r_tpu.utils import synthetic as jsyn

import starst3r_tpu_torch as stt
from starst3r_tpu_torch import imaging, native
from starst3r_tpu_torch.io import ply
from starst3r_tpu_torch.utils import camera, eval as teval, profiling
from starst3r_tpu_torch.utils import schedules, se3, synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native host runtime cannot be built here")


@pytest.mark.parametrize("colors", ["float", "uint8", "none"])
def test_ply_bytes_equal_jax(tmp_path, colors):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(257, 3)).astype(np.float32)
    cols = {"float": rng.uniform(-0.1, 1.1, size=(257, 3)),
            "uint8": rng.integers(0, 256, size=(257, 3)).astype(np.uint8),
            "none": None}[colors]
    mine, theirs = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    ply.save_ply(mine, pts, cols)
    jply.save_ply(theirs, pts, cols)
    assert filecmp.cmp(mine, theirs, shallow=False)
    for path in (mine, theirs):
        got, jgot = ply.load_ply(path), jply.load_ply(path)
        np.testing.assert_array_equal(got[0], jgot[0])
        np.testing.assert_array_equal(got[0], pts)
        if cols is None:
            assert got[1] is None and jgot[1] is None
        else:
            np.testing.assert_array_equal(got[1], jgot[1])


def test_native_source_is_the_root_copy():
    with open(os.path.join(ROOT, "csrc", "starst3r_native.cpp"), "rb") as f:
        root = f.read()
    with open(os.path.join(ROOT, "starst3r_tpu_torch", "csrc",
                           "starst3r_native.cpp"), "rb") as f:
        assert f.read() == root


def _native_case(fn, rng):
    if fn == "preprocess":
        img = rng.integers(0, 256, size=(90, 130, 3)).astype(np.uint8)
        return lambda m: m.preprocess(img, size=64, crop_mult=16)
    if fn == "preprocess_batch":
        imgs = [rng.integers(0, 256, size=(60 + 8 * i, 80, 3)).astype(
            np.uint8) for i in range(4)]
        return lambda m: m.preprocess_batch(imgs, size=48, crop_mult=8,
                                            n_threads=2)
    if fn == "hash64":
        data = rng.integers(0, 256, size=1001).astype(np.uint8)
        return lambda m: [m.hash64(data), m.hash64(data.tobytes(), seed=7)]
    rgb = rng.uniform(-0.2, 1.2, size=(17, 13, 3)).astype(np.float32)
    return lambda m: m.rgb_to_u8(rgb)


@pytest.mark.parametrize("fn", ["preprocess", "preprocess_batch", "hash64",
                                "rgb_to_u8"])
def test_native_equals_jax_native(fn):
    _need_gxx()
    assert native.available() and jnative.available()
    call = _native_case(fn, np.random.default_rng(1))
    got, want = call(native), call(jnative)
    if fn == "hash64":
        assert got == want
        return
    for g, w in zip(got if fn == "preprocess_batch" else [got],
                    want if fn == "preprocess_batch" else [want]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def img_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(2)
    paths = []
    for i in range(3):
        p = str(d / f"im_{i}.png")
        arr = rng.integers(0, 256, size=(50 + 6 * i, 70, 3)).astype(np.uint8)
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


@pytest.fixture
def no_compiler(tmp_path, monkeypatch):
    """A process where the native library was never built and g++ is not
    on the PATH."""
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    native._load.cache_clear()
    yield
    native._load.cache_clear()


@pytest.mark.parametrize("case", ["native_without_compiler",
                                  "default_without_compiler",
                                  "default_with_compiler", "pil"])
def test_load_images_routes(request, img_paths, case):
    if case.endswith("without_compiler"):
        request.getfixturevalue("no_compiler")
        assert not native.available()
        if case == "native_without_compiler":
            with pytest.raises(RuntimeError, match="g\\+\\+"):
                imaging.load_images(img_paths, size=48, impl="native")
            return
        want = st.load_images(img_paths, size=48, impl="pil")
    elif case == "default_with_compiler":
        _need_gxx()
        assert imaging.image_route() == "native"
        want = st.load_images(img_paths, size=48, impl="auto")
    else:
        want = st.load_images(img_paths, size=48, impl="pil")
    got = imaging.load_images(img_paths, size=48,
                              impl="pil" if case == "pil" else None)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout,mean,std", [("chw", 0.5, 0.5),
                                             ("hwc", 0.5, 0.5),
                                             ("hwc", 0.0, 1.0)])
def test_image_to_uint8_equals_jax(layout, mean, std):
    rng = np.random.default_rng(3)
    shape = (3, 9, 11) if layout == "chw" else (9, 11, 3)
    img = rng.uniform(-1.3, 1.3, size=shape).astype(np.float32)
    got = stt.image_to_uint8(img, mean=mean, std=std)
    want = st.image_to_uint8(img, mean=mean, std=std)
    assert got.dtype == np.uint8 and got.shape == (9, 11, 3)
    np.testing.assert_array_equal(got, want)


def _rot(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _helper_case(name, rng):
    """(port call, JAX call) on the same float32 inputs."""
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    T, J = torch.from_numpy, jnp.asarray
    if name == "make_intrinsics":
        foc, pp = np.abs(f32(5, 1)) + 1, f32(5, 2)
        return (lambda: camera.make_intrinsics(T(foc), T(pp)),
                lambda: jcam.make_intrinsics(J(foc), J(pp)))
    K = np.tile(np.array([[90.0, 0, 31.5], [0, 95.0, 30.0], [0, 0, 1]],
                         np.float32), (2, 1, 1))
    c2w = np.array(jse3.se3_from_quat_trans(J(_rot(rng, 2)), J(f32(2, 3))),
                   np.float32)
    if name == "unproject_depth":
        depth, pix = np.abs(f32(2, 7)) + 0.5, f32(2, 7, 2) * 20
        return (lambda: camera.unproject_depth(T(depth), T(K), T(c2w),
                                               T(pix)),
                lambda: jcam.unproject_depth(J(depth), J(K), J(c2w), J(pix)))
    if name == "project_points":
        pts = f32(2, 7, 3) + np.array([0, 0, 3], np.float32)
        pts[0, 0, 2] = 0.0
        return (lambda: camera.project_points(T(pts), T(K), T(c2w)),
                lambda: jcam.project_points(J(pts), J(K), J(c2w)))
    if name == "reproj2d":
        P, pts = f32(3, 4), f32(7, 3) + 3
        return (lambda: camera.reproj2d(T(P), T(pts)),
                lambda: jcam.reproj2d(J(P), J(pts)))
    if name == "quat_mul":
        a, b = f32(6, 4), f32(6, 4)
        return (lambda: se3.quat_mul(T(a), T(b)),
                lambda: jse3.quat_mul(J(a), J(b)))
    if name == "se3_from_quat_trans":
        q, t = _rot(rng, 6).astype(np.float32), f32(6, 3)
        return (lambda: se3.se3_from_quat_trans(T(q), T(t)),
                lambda: jse3.se3_from_quat_trans(J(q), J(t)))
    if name == "se3_compose":
        a, b = f32(3, 4, 4), f32(3, 4, 4)
        return (lambda: se3.se3_compose(T(a), T(b)),
                lambda: jse3.se3_compose(J(a), J(b)))
    alpha = np.linspace(0, 1, 9).astype(np.float32)
    if name == "linear_schedule":
        return (lambda: schedules.linear_schedule(T(alpha), 0.1, 1e-3),
                lambda: jsched.linear_schedule(J(alpha), 0.1, 1e-3))
    dist = np.abs(f32(40))
    return (lambda: schedules.gamma_loss(T(dist), 0.5),
            lambda: jsched.gamma_loss(J(dist), 0.5))


@pytest.mark.parametrize("name", [
    "make_intrinsics", "unproject_depth", "project_points", "reproj2d",
    "quat_mul", "se3_from_quat_trans", "se3_compose", "linear_schedule",
    "gamma_loss"])
def test_helpers_match_jax(name):
    mine, theirs = _helper_case(name, np.random.default_rng(4))
    got, want = mine(), theirs()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def _equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"snap_free": True}, {"anchored": True},
                                {"orbit": True}, {"focal_error": 0.05},
                                "image"], ids=str)
def test_synthetic_scenes_bit_for_bit(kw):
    if kw == "image":
        got = synthetic.synthetic_image_scene(3, 32, 45.0, 4)
        want = jsyn.synthetic_image_scene(3, 32, 45.0, 4)
    else:
        got = synthetic.synthetic_ga_scene(4, 64, 90.0, 8, **kw)
        want = jsyn.synthetic_ga_scene(4, 64, 90.0, 8, **kw)
    data, jdata = got[0], want[0]
    assert data._fields == jdata._fields
    for f in data._fields:
        assert _equal(getattr(data, f), getattr(jdata, f)), f
    assert got[1] == want[1]
    for g, w in zip(got[2:], want[2:]):
        assert _equal(g, w)


def _eval_inputs():
    rng = np.random.default_rng(5)
    gt = np.asarray(jse3.se3_from_quat_trans(
        jnp.asarray(_rot(rng, 5)), jnp.asarray(rng.normal(size=(5, 3)))),
        np.float64)
    noise = np.asarray(jse3.se3_from_quat_trans(
        jnp.asarray(_rot(rng, 5) * 0.05 + [1, 0, 0, 0]),
        jnp.asarray(rng.normal(size=(5, 3)) * 0.05)), np.float64)
    pred = noise @ gt
    pred[:, :3, 3] *= 2.5
    return pred, gt


@pytest.mark.parametrize("fn", ["umeyama", "align_trajectory", "ate_rmse",
                                "rpe_rotation_deg", "rotation_angle_deg",
                                "register_pose_into"])
def test_eval_equals_jax(fn):
    pred, gt = _eval_inputs()
    if fn == "umeyama":
        args = (pred[:, :3, 3], gt[:, :3, 3])
    elif fn == "register_pose_into":
        args = (gt[:4], pred[:4], gt[4])
    else:
        args = (pred, gt)
    got, want = getattr(teval, fn)(*args), getattr(jeval, fn)(*args)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _trace_files(path):
    return [f for f in os.listdir(path) if f.endswith(".json")] \
        if os.path.isdir(path) else []


@pytest.mark.parametrize("how", ["argument", "environment",
                                 "argument_over_environment", "none"])
def test_trace_if(tmp_path, monkeypatch, how):
    env_dir, arg_dir = str(tmp_path / "env"), str(tmp_path / "arg")
    if how == "none":
        monkeypatch.delenv("STARST3R_TRACE_DIR", raising=False)
    else:
        monkeypatch.setenv("STARST3R_TRACE_DIR",
                           env_dir if how != "argument" else "")
    trace_dir = None if how in ("environment", "none") else arg_dir
    with profiling.trace_if("phase", trace_dir):
        torch.ones(64, 64) @ torch.ones(64, 64)
    want = {"argument": arg_dir, "argument_over_environment": arg_dir,
            "environment": env_dir}.get(how)
    for base in (env_dir, arg_dir):
        files = _trace_files(os.path.join(base, "phase"))
        assert len(files) == (1 if base == want else 0), (base, files)
    if how == "none":
        assert profiling.trace_dir_from_env() is None
        assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_restore_pytree_equals_jax(tmp_path, writer):
    from typing import NamedTuple

    class Pair(NamedTuple):
        a: np.ndarray
        b: tuple

    rng = np.random.default_rng(6)
    tree = {"x": rng.normal(size=(3, 2)).astype(np.float32),
            "pair": Pair(np.arange(4, dtype=np.int32),
                         (rng.normal(size=5), np.float32(2.5))),
            "list": [np.ones((2, 2), np.float32)]}
    path = str(tmp_path / "tree.ckpt")
    (stt if writer == "port" else st).save_pytree(path, tree)
    got = stt.restore_pytree(path, tree)
    want = st.restore_pytree(path, tree)
    assert isinstance(got["pair"], Pair) and isinstance(got["list"], list)
    flat_got = dict(zip(*_flat_pairs(got)))
    flat_want = dict(zip(*_flat_pairs(want)))
    assert flat_got.keys() == flat_want.keys()
    for k in flat_got:
        assert _equal(flat_got[k], flat_want[k]), k
    with pytest.raises(KeyError, match="missing leaf"):
        stt.restore_pytree(path, {"y": np.zeros(1)})


def _flat_pairs(tree):
    from starst3r_tpu_torch.utils.checkpoint import flatten
    flat = flatten(tree)
    return list(flat), list(flat.values())


def _load_example(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_turntable_example_on_cpu(tmp_path):
    """examples/turntable_torch.py at the --quick width (64 px) with fewer
    training steps and frames: the GA recovers the planted poses, the loss
    falls, and the GIF and PNG are written."""
    mod = _load_example("turntable_torch")
    gif = str(tmp_path / "t.gif")
    out = mod.main(["--out", gif, "--hw", "64", "--iters", "4",
                    "--frames", "4", "--device", "cpu"])
    gt = out["gt_c2w"]
    scale = np.linalg.norm(gt[:, :3, 3] - gt[:, :3, 3].mean(0), axis=1).max()
    ate = teval.ate_rmse(out["ga"].cam2w.numpy(), gt)
    assert ate < 0.12 * scale, (ate, scale)
    assert len(out["losses"]) == 4 and np.all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert np.isfinite(out["psnr"])
    assert out["frames"].shape[1:] == (64, 64, 3)
    assert out["frames"].std() > 0
    assert os.path.exists(gif) and os.path.exists(str(tmp_path / "t.png"))


def test_demo_example_on_cpu(tmp_path):
    mod = _load_example("demo_torch")
    out = str(tmp_path / "demo")
    scene, losses = mod.main(["--synthetic", "--out", out, "--res", "64",
                              "--gs-iters", "4", "--device", "cpu"])
    assert len(scene.imgs) == 4 and scene.device.type == "cpu"
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    names = set(os.listdir(out))
    assert {f"render_{i}.png" for i in range(4)} <= names
    assert {f"novel_{i}.png" for i in range(5)} <= names
    assert "scene.ckpt" in names
    back = st.Scene.load(os.path.join(out, "scene.ckpt"))
    np.testing.assert_array_equal(back.c2w, scene.c2w)
