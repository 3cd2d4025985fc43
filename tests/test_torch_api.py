"""The port's public surface against the JAX package's, on the CPU.

  1. A signature walk over every public function, class and method of every
     `starst3r_tpu` module that has a counterpart of the same name in
     `starst3r_tpu_torch`: the port has the name, and for each JAX parameter
     the port takes the same name at the same position, with the same
     default. Two rules map one framework's idiom onto the other's: a flax
     module's ``__call__`` is the torch module's ``forward`` (its fields are
     torch constructor arguments, which also need the input widths flax
     infers), and a JAX dtype default is the torch dtype of that name. A
     module that reaches ``pl.pallas_call`` is a TPU kernel, ported as a
     CUDA source (PERF.md's kernel table), not as a module. Every other
     difference must be in `ALLOWED`, each with its reason, and every entry
     there must still be needed.
  2. Each call the port took over in its JAX spelling, held bit for bit to
     the port's keyword spelling (`reconstruct_scene` on the tiny model at
     64 px with the GA cut to 4 + 2), and the JAX backends the port does
     not have raise ValueError.

tests/test_torch_vit_modules.py holds the new modules' numbers to JAX's.
"""

import dataclasses
import importlib
import inspect
import os
import pkgutil

import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

import flax.linen as fnn
import jax.numpy as jnp

import starst3r_tpu as st
from starst3r_tpu.ops.attention import sdpa as jax_sdpa

import starst3r_tpu_torch as stt
from starst3r_tpu_torch import native
from starst3r_tpu_torch.alignment.ga import GAParams
from starst3r_tpu_torch.ops.attention import sdpa
from starst3r_tpu_torch.utils import compile_cache

from test_torch_rasterize import KW, _scene, _t

tr = importlib.import_module("starst3r_tpu_torch.splat.rasterize")

# {(where, what): why}. ``where`` is the JAX name's module and qualified
# name as defined (a re-export is the same entry); ``what`` the parameter,
# "*" for the whole signature, or None for a module.
ALLOWED = {
    ("*", "device"): "the port's entry points run on the card: `device` "
    "defaults to 'cuda', not None (nor the JAX Scene's 'tpu')",
    ("starst3r_tpu.splat.mcmc.relocate_dead", "key"): "the draws come from "
    "a torch.Generator (`generator=`), not a JAX key",
    ("starst3r_tpu.splat.mcmc.add_position_noise", "key"): "the draws come "
    "from a torch.Generator (`generator=`), not a JAX key",
    ("starst3r_tpu.models.mast3r.Mast3rModel.__init__", "*"): "(cfg, net, "
    "device): the wrapper holds a torch module on a device, not a params "
    "tree",
    ("starst3r_tpu.parallel.tp.tp_shard_params", "*"): "(model, mesh, "
    "axis): the port splits the torch model's layers in place of a params "
    "tree",
    ("starst3r_tpu.utils.jaxcache", None): "no module of that name: "
    "`utils.enable_compilation_cache` lives in utils/compile_cache.py",
}


def _modules():
    names = [st.__name__] + [m.name for m in pkgutil.walk_packages(
        st.__path__, st.__name__ + ".")]
    return [importlib.import_module(n) for n in names]


def _is_kernel_module(mod) -> bool:
    with open(mod.__file__) as f:
        return "pallas_call" in f.read()


def _public(mod):
    """(name, object) of the module's public functions and classes: those
    defined there, listed in its ``__all__``, or, for a package,
    re-exported from the JAX package."""
    is_pkg = hasattr(mod, "__path__")
    for name, obj in vars(mod).items():
        if name.startswith("_") or not (
                inspect.isfunction(obj) or inspect.isclass(obj)
                or hasattr(obj, "__wrapped__")):
            continue
        origin = getattr(obj, "__module__", "") or ""
        if origin == mod.__name__ or name in getattr(mod, "__all__", ()) \
                or (is_pkg and origin.split(".")[0] == "starst3r_tpu"):
            yield name, obj


def _function(x):
    return x.__func__ if isinstance(x, (classmethod, staticmethod)) else x


def _signature_pairs(where, jax_obj, port_obj):
    """(where, JAX callable, port callable) to compare for one name."""
    if not inspect.isclass(jax_obj):
        return [(where, jax_obj, port_obj)]
    if jax_obj.__module__.split(".")[0] != "starst3r_tpu":
        return []          # a JAX class the port mirrors by name only
    if issubclass(jax_obj, fnn.Module):
        return [(f"{where}.__call__", jax_obj.__call__, port_obj.forward)]
    pairs = []
    for name, member in vars(jax_obj).items():
        fn = _function(member)
        if (name.startswith("_") and name != "__init__") \
                or not inspect.isfunction(fn):
            continue
        port_fn = inspect.getattr_static(port_obj, name, None)
        pairs.append((f"{where}.{name}", fn,
                      None if port_fn is None else _function(port_fn)))
    return pairs


def _params(fn):
    return [p for p in inspect.signature(fn).parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def _same_default(a, b) -> bool:
    if a is b:
        return True
    if isinstance(b, torch.dtype):      # a JAX dtype default
        return np.dtype(a).name == str(b).removeprefix("torch.")
    try:
        return bool(a == b)
    except Exception:
        return False


def _compare(where, jax_fn, port_fn, used):
    """The problems of one signature pair; marks the allow-list entries
    that excuse a difference as used."""
    if port_fn is None:
        return [f"{where}: missing in the port"]
    if (where, "*") in ALLOWED:
        used.add((where, "*"))
        return []
    jp, pp = _params(jax_fn), _params(port_fn)
    if (where, "key") in ALLOWED and jp[0].name == "key":
        used.add((where, "key"))
        jp = jp[1:]
        if "generator" not in [p.name for p in pp]:
            return [f"{where}: no generator in place of the key"]
    if [p.name for p in pp][:len(jp)] != [p.name for p in jp]:
        return [f"{where}: JAX takes {[p.name for p in jp]}, the port "
                f"{[p.name for p in pp]}"]
    out = []
    for a, b in zip(jp, pp):
        if _same_default(a.default, b.default):
            continue
        if a.name == "device" and b.default == "cuda" \
                and a.default in (None, "tpu"):
            used.add(("*", "device"))
            continue
        out.append(f"{where}({a.name}): JAX default {a.default!r}, the "
                   f"port's {b.default!r}")
    return out


def test_public_signatures_match_the_jax_package():
    problems, used, walked = [], set(), 0
    for mod in _modules():
        port_name = "starst3r_tpu_torch" + mod.__name__[len("starst3r_tpu"):]
        if _is_kernel_module(mod):
            continue
        try:
            port = importlib.import_module(port_name)
        except ModuleNotFoundError:
            if (mod.__name__, None) in ALLOWED:
                used.add((mod.__name__, None))
            else:
                problems.append(f"{mod.__name__}: no port module")
            continue
        for name, obj in _public(mod):
            where = f"{getattr(obj, '__module__', mod.__name__)}." \
                    f"{getattr(obj, '__qualname__', name)}"
            if not hasattr(port, name):
                problems.append(f"{port_name}.{name}: missing")
                continue
            for pair in _signature_pairs(where, obj, getattr(port, name)):
                walked += 1
                problems += _compare(*pair, used)
    assert problems == [], "\n".join(problems)
    assert walked > 200
    assert used == set(ALLOWED), f"unused entries: {set(ALLOWED) - used}"


def test_allow_list_is_the_short_one():
    # five idioms, the generator one for two functions
    assert len(ALLOWED) == 6
    assert all(why and "\n" not in why for why in ALLOWED.values())


# -- each repaired call in the JAX spelling ----------------------------------

H = W = 64


@pytest.fixture(scope="module")
def tiny_model():
    return stt.Mast3rModel.init_random(stt.ModelConfig.tiny(), seed=0,
                                       device="cpu")


def test_init_random_takes_image_hw(tiny_model):
    got = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(), 0, (H, W),
                                      "cpu")
    kw = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(), 0,
                                     image_hw=(224, 224), device="cpu")
    for m in (got, kw):
        assert m.device == torch.device("cpu")
        for k, v in m.state_dict().items():
            assert torch.equal(v, tiny_model.state_dict()[k]), k


def test_reconstruct_scene_takes_filelist(tiny_model, tmp_path):
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1, 1, (3, H, W)).astype(np.float32)
            for _ in range(3)]
    cfg = stt.default_config()
    cfg = dataclasses.replace(cfg, ga=dataclasses.replace(
        cfg.ga, niter1=4, niter2=2))
    files = [f"im_{i}.png" for i in range(3)]
    got, gp = stt.reconstruct_scene(tiny_model, imgs, files, "cpu",
                                    tmpdir=str(tmp_path / "a"), config=cfg)
    want, wp = stt.reconstruct_scene(tiny_model, imgs, device="cpu",
                                     tmpdir=str(tmp_path / "b"), config=cfg)
    np.testing.assert_array_equal(got.cam2w, want.cam2w)
    np.testing.assert_array_equal(got.intrinsics, want.intrinsics)
    np.testing.assert_array_equal(got.core_depth, want.core_depth)
    for a, b in zip(gp, wp):
        assert torch.equal(a, b)
    kw, _ = stt.reconstruct_scene(tiny_model, imgs, filelist=files,
                                  device="cpu", tmpdir=str(tmp_path / "a"),
                                  config=cfg)
    np.testing.assert_array_equal(kw.cam2w, want.cam2w)


@pytest.fixture(scope="module")
def img_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(1)
    paths = []
    for i in range(2):
        p = str(d / f"im_{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 56, 3)).astype(
            np.uint8)).save(p)
        paths.append(p)
    return paths


def test_load_images_takes_impl_auto(img_paths):
    got = stt.load_images(img_paths, 48, 16, "auto")
    for impl in (None, "native" if native.available() else "pil"):
        want = stt.load_images(img_paths, size=48, impl=impl)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert stt.imaging.image_route("auto") == stt.imaging.image_route()


def test_rasterize_takes_impl_auto():
    args = _t(_scene())
    kw = [KW[k] for k in ("width", "height", "sh_degree", "tile_size",
                          "max_tiles_per_gaussian", "max_per_tile", "chunk")]
    want = tr.rasterize(*args, **KW)
    for got in (tr.rasterize(*args, *kw, "auto"),
                tr.rasterize(*args, *kw, "auto", None),
                stt.gs.rasterize(*args, **KW, impl="auto")):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("impl", ["pallas", "xla", "ref", "plain"])
def test_rasterize_refuses_other_backends(impl):
    with pytest.raises(ValueError, match="'auto'"):
        tr.rasterize(*_t(_scene()), **KW, impl=impl)


def test_sdpa_takes_impl():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 6, 4, 8, generator=g) for _ in range(3))
    want = sdpa(q, k, v)
    for impl in ("xla", "einsum"):
        assert torch.equal(sdpa(q, k, v, impl), want)
        assert torch.equal(sdpa(q, k, v, impl=impl), want)
    np.testing.assert_allclose(
        want.numpy(), np.asarray(jax_sdpa(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()))), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="einsum"):
        sdpa(q, k, v, impl="pallas")


def test_load_images_refuses_other_impls(img_paths):
    with pytest.raises(ValueError, match="'auto'"):
        stt.load_images(img_paths, size=48, impl="bogus")


def _need_gxx():
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++ here")


def test_compilation_cache_and_forced_native_build(tmp_path, monkeypatch):
    """`enable_compilation_cache(path)` moves the native library's build
    there; `native.build(force=True)` builds it anew over the file and
    drops the process's loaded handle; `STARST3R_NO_COMPILE_CACHE=1` makes
    the call a no-op; a call without a path goes back to `_build/`."""
    _need_gxx()
    monkeypatch.setattr(compile_cache, "_dir", None)
    default = compile_cache.build_dir()
    assert default.name == "_build"
    monkeypatch.setenv("STARST3R_NO_COMPILE_CACHE", "1")
    stt.utils.enable_compilation_cache(tmp_path / "ignored")
    assert compile_cache.build_dir() == default
    monkeypatch.delenv("STARST3R_NO_COMPILE_CACHE")
    stt.utils.enable_compilation_cache(str(tmp_path / "cache"))
    assert compile_cache.build_dir() == (tmp_path / "cache").resolve()
    so = native._lib_path()
    assert so.parent == (tmp_path / "cache").resolve()
    assert native.available() and so.exists()
    digest = native.hash64(b"starst3r")
    ino = os.stat(so).st_ino
    assert native.build() and os.stat(so).st_ino == ino
    assert native.build(force=True)
    assert os.stat(so).st_ino != ino
    assert native._load.cache_info().currsize == 0
    assert native.available() and native.hash64(b"starst3r") == digest
    stt.utils.enable_compilation_cache()
    assert compile_cache.build_dir() == default


def test_kernel_builds_go_to_the_cache_dir(tmp_path, monkeypatch):
    from starst3r_tpu_torch import kernels
    monkeypatch.setattr(compile_cache, "_dir", None)
    before = kernels._so_path("gather_entries")
    stt.utils.enable_compilation_cache(tmp_path)
    after = kernels._so_path("gather_entries")
    assert after.parent == tmp_path.resolve() and after.name == before.name


def test_tree_prefix_overwrite_is_the_ga_warm_start():
    """The GA's warm start is `utils.tree_prefix_overwrite` over GAParams:
    the common leading slice of each field taken from the previous run."""
    g = torch.Generator().manual_seed(0)
    new = GAParams(*(torch.randn(4, *s, generator=g)
                     for s in ((2,), (), (4,), (3,), (), (5,))))
    prev = GAParams(*(torch.randn(3, *s, generator=g)
                      for s in ((2,), (), (4,), (3,), (), (5,))))
    got = GAParams(*stt.utils.tree_prefix_overwrite(tuple(new),
                                                    tuple(prev)))
    for n, p, o in zip(new, prev, got):
        assert torch.equal(o[:3], p) and torch.equal(o[3:], n[3:])
    assert stt.utils.tree_prefix_overwrite(new, None) is new


def test_splat_exports_config_and_optimizer():
    assert stt.splat.SplatConfig is stt.SplatConfig
    from starst3r_tpu_torch.splat.train import (AdamState, adam_update,
                                                make_optimizer)
    cfg = stt.SplatConfig(lr_means=1e-2)
    g = torch.Generator().manual_seed(0)
    params = {"means": torch.randn(5, 3, generator=g),
              "sh0": torch.randn(5, 1, 3, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    opt = make_optimizer(cfg)
    state = opt.init(params)
    assert isinstance(state, AdamState) and state.count == 0
    updates, state1 = opt.update(grads, state, params)
    stepped, state2 = adam_update(grads, state, params, cfg)
    for k in params:
        assert torch.equal(params[k] + updates[k], stepped[k])
        assert torch.equal(state1.mu[k], state2.mu[k])
        assert torch.equal(state1.nu[k], state2.nu[k])
    assert state1.count == state2.count == 1
