"""The port's new public pieces against the JAX package's, on the CPU:

  - `models.vit.Encoder` (depth 2, dim 64, heads 4, patch 16, two 32 x 48
    images) and `models.vit.InterleavedDecoder` (depth 2, dim 64, enc_dim
    64, the two streams at different patch positions), built in JAX with
    ``dtype=jnp.float32``, every parameter drawn from a numpy seed, carried
    over by `io.from_jax.encoder_state_dict_from_jax` /
    `decoder_state_dict_from_jax`: every output within 1e-5 x its largest
    magnitude;
  - `utils.tree_prefix_overwrite` on nested dicts, tuples, NamedTuples and
    lists with leaves of differing shapes and ``None`` in the previous
    tree, along axes 0 and 1: equal;
  - `models.mast3r.restore_pytree_npz` on a file of the JAX package's
    `save_pretrained` and on one of the port's, each read by both packages
    into a tree shaped like the same ``like`` (a leaf cast to bfloat16 in
    it): equal, and a missing leaf raises KeyError naming it in both;
  - `splat.train.make_optimizer` with a different learning rate per key:
    two updates and their states against optax's, within 1e-6 of the
    largest update.
"""

from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp
import optax  # noqa: F401  (the JAX optimizer under test)

import starst3r_tpu as st
from starst3r_tpu.models import mast3r as jmast3r
from starst3r_tpu.models import vit as jvit
from starst3r_tpu.splat import train as jtrain
from starst3r_tpu.utils import tree_prefix_overwrite as jax_overwrite

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.io.from_jax import (decoder_state_dict_from_jax,
                                            encoder_state_dict_from_jax)
from starst3r_tpu_torch.io.torch_convert import convert_state_dict
from starst3r_tpu_torch.models import mast3r as tmast3r
from starst3r_tpu_torch.models import vit as tvit
from starst3r_tpu_torch.splat import train as ttrain
from starst3r_tpu_torch.utils import tree_prefix_overwrite

TOL = 1e-5     # of the output's largest magnitude
DIM, HEADS, DEPTH = 64, 4, 2


def _numpy_params(module, seed, *example):
    """The module's flax parameters with every leaf drawn from a numpy seed
    (LayerNorm scales near 1, the rest small). The shapes come from an
    eager `init`: under a trace, the JAX package's `ops/rope.py` would
    cache a tracer (ROADMAP.md, reference faults)."""
    shapes = module.init(jax.random.PRNGKey(0), *example)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            x = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            fan_in = leaf.shape[0] if len(leaf.shape) == 2 else \
                int(np.prod(leaf.shape[:-1]))
            x = rng.standard_normal(leaf.shape) / np.sqrt(max(fan_in, 1))
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= TOL * scale, (err, scale)


def test_encoder_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    jenc = jvit.Encoder(DEPTH, DIM, HEADS, patch_size=16,
                        dtype=jnp.float32)
    params = _numpy_params(jenc, 1, jnp.asarray(img))
    want = jenc.apply(params, jnp.asarray(img))
    tenc = tvit.Encoder(DEPTH, DIM, HEADS, 16, 4.0, 100.0)
    tenc.load_state_dict(encoder_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = tenc(torch.from_numpy(img))
    assert got.shape == (2, 6, DIM)
    _close(got, want)


def test_interleaved_decoder_matches_jax():
    rng = np.random.default_rng(2)
    f1, f2 = (rng.standard_normal((2, 6, DIM)).astype(np.float32)
              for _ in range(2))
    pos1 = np.array(jvit.patch_positions(2, 3))[None]
    pos2 = pos1[:, ::-1].copy()            # the streams at other positions
    jdec = jvit.InterleavedDecoder(DEPTH, DIM, HEADS, enc_dim=DIM,
                                   dtype=jnp.float32)
    args = tuple(jnp.asarray(a) for a in (f1, f2, pos1, pos2))
    params = _numpy_params(jdec, 3, *args)
    want1, want2 = jdec.apply(params, *args)
    tdec = tvit.InterleavedDecoder(DEPTH, DIM, HEADS, DIM, 4.0, 100.0)
    tdec.load_state_dict(decoder_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got1, got2 = tdec(*(torch.from_numpy(a) for a in (f1, f2)),
                          torch.from_numpy(pos1), torch.from_numpy(pos2))
    assert len(got1) == len(got2) == DEPTH + 1
    for got, want in zip(got1 + got2, list(want1) + list(want2)):
        _close(got, want)


class Pair(NamedTuple):
    a: object
    b: object


def _trees(rng, axis):
    """(new, prev) trees of numpy leaves: the previous run had fewer
    entries along ``axis`` and other trailing sizes; a None in prev keeps
    new's leaf."""
    def leaf(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    new = {"cams": Pair(leaf(5, 4), [leaf(6, 3, 2), leaf(4, 7)]),
           "depth": (leaf(5, 8), leaf(3, 3)), "keep": leaf(4, 2)}
    prev = {"cams": Pair(leaf(3, 4), [leaf(4, 5, 2), leaf(2, 9)]),
            "depth": (leaf(3, 6), leaf(3, 3)), "keep": None}
    if axis == 1:           # fewer entries along axis 1 instead
        new["depth"] = (leaf(5, 8), leaf(4, 6))
        prev["depth"] = (leaf(5, 3), leaf(2, 9))
    return new, prev


@pytest.mark.parametrize("axis", [0, 1])
def test_tree_prefix_overwrite_matches_jax(axis):
    new, prev = _trees(np.random.default_rng(4 + axis), axis)
    want = jax_overwrite(new, prev, axis=axis)
    to_t = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)  # noqa
    got = tree_prefix_overwrite(to_t(new), to_t(prev), axis=axis)
    assert isinstance(got["cams"], Pair) and isinstance(got["cams"].b, list)
    flat_g = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda x: x.numpy(), got,
                               is_leaf=lambda x: isinstance(x, torch.Tensor)))
    flat_w = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    assert len(flat_g) == len(flat_w) == 6
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got["keep"].numpy(), new["keep"])


@pytest.fixture(scope="module")
def pretrained_files(tmp_path_factory):
    """A tiny model's weights written by the JAX package's
    `save_pretrained` and by the port's, and the flax-layout ``like``
    tree."""
    d = tmp_path_factory.mktemp("pretrained")
    cfg = stt.ModelConfig.tiny()
    tmodel = stt.Mast3rModel.init_random(cfg, seed=7, device="cpu")
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    like, _ = convert_state_dict(sd, cfg.enc_depth, cfg.dec_depth,
                                 cfg.patch_size, cfg.desc_dim)
    jmodel = st.Mast3rModel(st.ModelConfig.tiny(), like)
    jmodel.save_pretrained(str(d / "jax.npz"))
    tmodel.save_pretrained(str(d / "port.npz"))
    return {"jax": str(d / "jax.npz"), "port": str(d / "port.npz")}, like


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_restore_pytree_npz_matches_jax(pretrained_files, writer):
    files, like = pretrained_files
    like = jax.tree_util.tree_map(np.asarray, like)
    blk = like["params"]["encoder"]["block0"]["attn"]["qkv"]
    blk["kernel"] = blk["kernel"].astype(jnp.bfloat16)
    want = jmast3r.restore_pytree_npz(files[writer], like)
    got = tmast3r.restore_pytree_npz(files[writer], like)
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl] and len(gl) > 50
    for (path, g), (_, w) in zip(gl, wl):
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))
    assert got["params"]["encoder"]["block0"]["attn"]["qkv"][
        "kernel"].dtype == jnp.bfloat16
    # a tensor leaf comes back as a tensor of its dtype
    t_like = {"params": {"encoder": {"norm": {
        "scale": torch.zeros(1, dtype=torch.float64)}}}}
    t_got = tmast3r.restore_pytree_npz(files[writer], t_like)
    scale = t_got["params"]["encoder"]["norm"]["scale"]
    assert isinstance(scale, torch.Tensor) and scale.dtype == torch.float64
    missing = {"params": {"encoder": {"nope": np.zeros(1, np.float32)}}}
    for fn in (jmast3r.restore_pytree_npz, tmast3r.restore_pytree_npz):
        with pytest.raises(KeyError, match="params/encoder/nope"):
            fn(files[writer], missing)


def test_make_optimizer_matches_optax():
    cfg_kw = dict(lr=1e-3, lr_means=1.6e-4, lr_quats=1e-3, lr_scales=5e-3,
                  lr_opacities=5e-2, lr_sh=2.5e-3)
    jopt = jtrain.make_optimizer(st.SplatConfig(**cfg_kw))
    topt = ttrain.make_optimizer(stt.SplatConfig(**cfg_kw))
    rng = np.random.default_rng(5)
    shapes = {"means": (16, 3), "quats": (16, 4), "scales": (16, 3),
              "opacities": (16,), "sh0": (16, 1, 3), "shN": (16, 3, 3)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jstate = jopt.init({k: jnp.asarray(v) for k, v in params.items()})
    tstate = topt.init({k: torch.from_numpy(v) for k, v in params.items()})
    for _ in range(2):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        jup, jstate = jopt.update({k: jnp.asarray(v)
                                   for k, v in grads.items()}, jstate)
        tup, tstate = topt.update({k: torch.from_numpy(v)
                                   for k, v in grads.items()}, tstate)
        scale = max(float(np.abs(np.asarray(v)).max())
                    for v in jup.values())
        for k in shapes:
            err = float(np.abs(tup[k].numpy() - np.asarray(jup[k])).max())
            assert err <= 1e-6 * scale, (k, err, scale)
            np.testing.assert_allclose(tstate.mu[k].numpy(),
                                       np.asarray(jstate[0].mu[k]),
                                       rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(tstate.nu[k].numpy(),
                                       np.asarray(jstate[0].nu[k]),
                                       rtol=1e-6, atol=1e-12)
        assert tstate.count == int(jstate[0].count)
