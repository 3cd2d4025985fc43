"""Checkpoints across the two packages: scenes (`Scene.save` / `load`),
models (`save_pretrained` / `from_pretrained`) and the `.pth`-layout
conversion behind them.

Every file written by one package is read by the other. Scenes carry their
arrays bit for bit (float32 and int32 as written), so equality is exact.
Models are compared by their weights, exactly, and by the pair outputs of
the two networks on the same images with tests/test_torch_parity.py's
tolerances (float32 on the CPU, TF32 off): pts 5e-4, conf and descriptors
1e-3, rtol 2e-3.
"""

import os
from typing import NamedTuple

import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

import starst3r_tpu as st
from starst3r_tpu.io.torch_convert import convert_state_dict as j_convert
from starst3r_tpu.splat.train import GSState as JGSState
from starst3r_tpu.utils import checkpoint as jckpt

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.alignment.ga import GAParams
from starst3r_tpu_torch.io.from_jax import mast3r_state_dict_from_jax
from starst3r_tpu_torch.io.torch_convert import convert_state_dict
from starst3r_tpu_torch.splat.train import GSState, adam_init
from starst3r_tpu_torch.utils import checkpoint as tckpt

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H = W = 64
CFG = stt.ModelConfig.tiny()
OUT_ATOL = {"pts1": 5e-4, "pts2": 5e-4, "conf1": 1e-3, "conf2": 1e-3,
            "desc1": 1e-3, "desc2": 1e-3, "desc_conf1": 1e-3,
            "desc_conf2": 1e-3}


def _state(seed=0, c=3, n=50, s=16):
    """A scene's contents as numpy, made from a seed."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)
    return dict(
        c2w=f32(c, 4, 4), intrinsics=f32(c, 3, 3),
        raw_imgs=[rng.uniform(-1, 1, (3, 16, 16)).astype(np.float32)
                  for _ in range(c)],
        imgs=[rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
              for _ in range(c)],
        optim_params=[f32(c, 2), f32(c), f32(c, 4), f32(c, 3), f32(c),
                      f32(c, s)],
        gaussians=dict(means=f32(n, 3), quats=f32(n, 4), scales=f32(n, 3),
                       opacities=f32(n), sh0=f32(n, 1, 3), shN=f32(n, 4, 3)),
        n_alive=37)


def _port_scene(d, gaussians=True):
    sc = stt.Scene(device="cpu")
    sc.c2w, sc.intrinsics = d["c2w"], d["intrinsics"]
    sc.raw_imgs, sc.imgs = list(d["raw_imgs"]), list(d["imgs"])
    sc.optim_params = GAParams(*[torch.from_numpy(x)
                                 for x in d["optim_params"]])
    if gaussians:
        params = {k: torch.from_numpy(v) for k, v in d["gaussians"].items()}
        sc.gs_state = GSState(params, adam_init(params), 5,
                              torch.Generator(), d["n_alive"])
    return sc


def _jax_scene(d):
    sc = st.Scene()
    sc.c2w, sc.intrinsics = d["c2w"], d["intrinsics"]
    sc.raw_imgs, sc.imgs = list(d["raw_imgs"]), list(d["imgs"])
    sc.optim_params = st.alignment.GAParams(
        *[jnp.asarray(x) for x in d["optim_params"]])
    params = {k: jnp.asarray(v) for k, v in d["gaussians"].items()}
    sc.gs_state = JGSState(params, optax.adam(1e-3).init(params),
                           jnp.asarray(5), jax.random.PRNGKey(1),
                           jnp.asarray(d["n_alive"], jnp.int32))
    return sc


def _assert_scene(got, d, to_np):
    np.testing.assert_array_equal(got.c2w, d["c2w"])
    np.testing.assert_array_equal(got.intrinsics, d["intrinsics"])
    np.testing.assert_array_equal(np.stack(got.raw_imgs),
                                  np.stack(d["raw_imgs"]))
    np.testing.assert_array_equal(np.stack(got.imgs), np.stack(d["imgs"]))
    assert len(got.optim_params) == 6
    for a, b in zip(got.optim_params, d["optim_params"]):
        np.testing.assert_array_equal(to_np(a), b)
    assert sorted(got.gs_state.params) == sorted(d["gaussians"])
    for k, v in d["gaussians"].items():
        np.testing.assert_array_equal(to_np(got.gs_state.params[k]), v)
    assert int(got.gs_state.n_alive) == d["n_alive"]


def _port_np(x):
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    return x.numpy()


class _Pair(NamedTuple):
    a: np.ndarray
    b: tuple


def test_flatten_names_leaves_as_jax():
    """dict keys (sorted), tuple and list indices, NamedTuple field names;
    None and empty containers hold no leaf."""
    x = np.arange(3, dtype=np.float32)
    tree = {"z": (x, [x * 2, None]), "a": _Pair(x + 1, (x - 1, {})),
            "m": {"k": np.int32(4)}, "e": ()}
    got = tckpt.flatten(tree)
    want = jckpt._flatten(tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    got_t = tckpt.flatten({"t": torch.from_numpy(x), "p": GAParams(
        *[torch.zeros(1)] * 6)})
    assert sorted(got_t) == ["p/core_depth", "p/log_focals", "p/log_sizes",
                             "p/pps", "p/quats", "p/trans", "t"]


def test_port_scene_save_loads_in_jax_and_port(tmp_path):
    d = _state(0)
    path = str(tmp_path / "scene.ckpt")
    _port_scene(d).save(path)
    assert sorted(os.listdir(tmp_path)) == ["scene.ckpt"]   # no .npz added
    with np.load(path) as z:
        assert "__treedef__" in z.files
    assert sorted(tckpt.load_flat(path)) == sorted(jckpt.load_flat(path))
    _assert_scene(st.Scene.load(path), d, np.asarray)
    back = stt.Scene.load(path, device="cpu")
    _assert_scene(back, d, _port_np)
    # the fresh optimiser state: Adam count 0, zero moments, a generator
    # seeded 0
    gs = back.gs_state
    assert gs.step == 0 and gs.opt_state.count == 0
    assert all(float(v.abs().sum()) == 0.0 for v in gs.opt_state.mu.values())
    assert all(float(v.abs().sum()) == 0.0 for v in gs.opt_state.nu.values())
    assert torch.equal(gs.generator.get_state(),
                       torch.Generator().manual_seed(0).get_state())


def test_jax_scene_save_loads_in_port(tmp_path):
    d = _state(1)
    path = str(tmp_path / "scene.ckpt")
    _jax_scene(d).save(path)
    _assert_scene(stt.Scene.load(path, device="cpu"), d, _port_np)


def test_legacy_checkpoint_without_raw_imgs(tmp_path):
    """A file without raw_imgs: both packages rebuild them from the
    display images, identically."""
    d = _state(2)
    path = str(tmp_path / "legacy.ckpt")
    jckpt.save_pytree(path, {
        "c2w": d["c2w"], "intrinsics": d["intrinsics"],
        "imgs": np.stack(d["imgs"]), "optim_params": tuple(d["optim_params"]),
        "gaussians": d["gaussians"],
        "gs_n_alive": np.asarray(d["n_alive"], np.int32)})
    js = st.Scene.load(path)
    ts = stt.Scene.load(path, device="cpu")
    assert len(ts.raw_imgs) == len(js.raw_imgs) == 3
    for a, b in zip(ts.raw_imgs, js.raw_imgs):
        assert a.shape == (3, 16, 16)
        np.testing.assert_array_equal(a, b)
    d["raw_imgs"] = js.raw_imgs
    _assert_scene(ts, d, _port_np)


def test_scene_without_gaussians_round_trip(tmp_path):
    d = _state(3)
    path = str(tmp_path / "bare.ckpt")
    sc = _port_scene(d, gaussians=False)
    sc.optim_params = None
    sc.save(path)
    for loaded in (st.Scene.load(path), stt.Scene.load(path, device="cpu")):
        assert loaded.gs_state is None and loaded.optim_params is None
        np.testing.assert_array_equal(loaded.c2w, d["c2w"])
    with np.load(path) as z:
        assert z["gs_n_alive"].dtype == np.int32


@pytest.fixture(scope="module")
def models():
    jmodel = st.Mast3rModel.init_random(st.ModelConfig.tiny(), seed=3,
                                        image_hw=(H, W))
    tmodel = stt.Mast3rModel.init_random(CFG, seed=5, device="cpu")
    return jmodel, tmodel


def _pair_outputs(model, seed=11):
    rng = np.random.default_rng(seed)
    img1 = rng.uniform(-1, 1, size=(2, H, W, 3)).astype(np.float32)
    img2 = rng.uniform(-1, 1, size=(2, H, W, 3)).astype(np.float32)
    if isinstance(model, stt.Mast3rModel):
        out = model.infer_pair_batch(torch.from_numpy(img1),
                                     torch.from_numpy(img2))
        return {k: v.numpy() for k, v in out.items()}
    out = model.infer_pair_batch(jnp.asarray(img1), jnp.asarray(img2))
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_outputs(got, want):
    for key, atol in OUT_ATOL.items():
        np.testing.assert_allclose(got[key], want[key], atol=atol,
                                   rtol=2e-3, err_msg=key)


def test_port_save_pretrained_loads_in_jax_and_port(models, tmp_path):
    _, tmodel = models
    base = str(tmp_path / "model")
    tmodel.save_pretrained(base)
    # np.savez on an extension-less str path appends ".npz", as in JAX
    assert sorted(os.listdir(tmp_path)) == ["model.npz"]
    jback = st.Mast3rModel.from_pretrained(base + ".npz")
    assert jback.cfg == st.ModelConfig.tiny()
    _assert_outputs(_pair_outputs(jback), _pair_outputs(tmodel))
    tback = stt.Mast3rModel.from_pretrained(base + ".npz", device="cpu")
    assert tback.cfg == CFG
    want = tmodel.state_dict()
    got = tback.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the dead weights the format does not carry are zero in both
    assert float(want["mask_token"].abs().sum()) == 0.0
    assert float(want["downstream_head1.dpt.scratch.refinenet4."
                      "resConfUnit1.conv1.weight"].abs().sum()) == 0.0


def test_jax_save_pretrained_loads_in_port(models, tmp_path):
    jmodel, _ = models
    path = str(tmp_path / "jax_model.npz")
    jmodel.save_pretrained(path)
    tback = stt.Mast3rModel.from_pretrained(path, device="cpu")
    want = mast3r_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jmodel.params))
    got = tback.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    _assert_outputs(_pair_outputs(tback), _pair_outputs(jmodel))
    # the geometry comes from the file; a given cfg overrides it
    tcfg = stt.Mast3rModel.from_pretrained(path, cfg=CFG, device="cpu")
    assert tcfg.cfg is CFG


def test_from_pretrained_missing_key_raises(models, tmp_path):
    _, tmodel = models
    path = str(tmp_path / "m.npz")
    tmodel.save_pretrained(path)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    gone = [k for k in flat if k.endswith("norm1/bias")][0]
    del flat[gone]
    np.savez(path, **flat)
    with pytest.raises(KeyError):
        stt.Mast3rModel.from_pretrained(path, device="cpu")
    with pytest.raises(KeyError):          # the JAX package agrees
        st.Mast3rModel.from_pretrained(path)


def test_convert_state_dict_matches_jax(models):
    """The port's copy of the .pth mapping: no unmapped key, the JAX
    converter's tree leaf for leaf, and `mast3r_state_dict_from_jax` gives
    the state dict back exactly."""
    _, tmodel = models
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    got, unmapped = convert_state_dict(sd, CFG.enc_depth, CFG.dec_depth,
                                       CFG.patch_size, CFG.desc_dim)
    want, j_unmapped = j_convert(sd, CFG.enc_depth, CFG.dec_depth,
                                 CFG.patch_size, CFG.desc_dim)
    assert unmapped == j_unmapped == []
    g, w = tckpt.flatten(got), jckpt._flatten(want)
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == w[k].dtype
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    back = mast3r_state_dict_from_jax(got)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
