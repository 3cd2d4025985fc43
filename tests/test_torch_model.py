"""The port's network against the JAX package's, on the same weights.

The JAX `TwoViewNet` is initialised from a seed; its flax params go through
`starst3r_tpu_torch.io.from_jax.mast3r_state_dict_from_jax` into the port's
`TwoViewNet`, and the same numpy images go through both. Tolerances are
those of tests/test_torch_parity.py (float32 on the CPU, TF32 off).
"""

import numpy as np
import pytest
import torch
from torch_attention_cases import attention_inputs
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

import starst3r_tpu as st
from starst3r_tpu.io.torch_convert import convert_state_dict
from starst3r_tpu.models import heads as jheads
from starst3r_tpu.ops import rope as jrope

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.io.from_jax import mast3r_state_dict_from_jax
from starst3r_tpu_torch.models import heads as theads
from starst3r_tpu_torch.ops import rope as trope

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H = W = 64
CFG = st.ModelConfig.tiny()

# tests/test_torch_parity.py:453-456
OUT_ATOL = {"pts1": 5e-4, "pts2": 5e-4, "conf1": 1e-3, "conf2": 1e-3,
            "desc1": 1e-3, "desc2": 1e-3, "desc_conf1": 1e-3,
            "desc_conf2": 1e-3}


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


@pytest.fixture(scope="module")
def models():
    jmodel = st.Mast3rModel.init_random(CFG, seed=3, image_hw=(H, W))
    tmodel = stt.Mast3rModel.init_random(CFG, seed=0, device="cpu")
    tmodel.load_state_dict(mast3r_state_dict_from_jax(
        _np_params(jmodel.params)))
    return jmodel, tmodel


def test_state_dict_is_inverse_of_torch_convert(models):
    """from_jax is the inverse of the JAX package's .pth converter: the
    port's state dict (the checkpoint layout) converts back to the very
    params it came from, with no unmapped key."""
    jmodel, tmodel = models
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    mapped, unmapped = convert_state_dict(sd, CFG.enc_depth, CFG.dec_depth,
                                          CFG.patch_size, CFG.desc_dim)
    assert unmapped == []
    want = jax.tree_util.tree_leaves_with_path(
        _np_params(jmodel.params)["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(mapped["params"]))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf,
                                      err_msg=jax.tree_util.keystr(path))


def test_pair_outputs_match_jax(models):
    jmodel, tmodel = models
    rng = np.random.default_rng(11)
    img1 = rng.uniform(-1, 1, size=(2, H, W, 3)).astype(np.float32)
    img2 = rng.uniform(-1, 1, size=(2, H, W, 3)).astype(np.float32)
    want = jmodel.infer_pair_batch(jnp.asarray(img1), jnp.asarray(img2))
    got = tmodel.infer_pair_batch(torch.from_numpy(img1),
                                  torch.from_numpy(img2))
    for key, atol in OUT_ATOL.items():
        assert got[key].dtype == torch.float32, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, rtol=2e-3, err_msg=key)


def test_infer_pairs_pads_last_batch_like_jax(models):
    """3 images, 6 ordered pairs at batch 4: the second batch is padded to
    full size and the padding is dropped, as in the JAX package."""
    jmodel, tmodel = models
    rng = np.random.default_rng(12)
    imgs = [rng.uniform(-1, 1, size=(3, H, W)).astype(np.float32)
            for _ in range(3)]
    pairs = stt.make_pair_indices(3)
    assert pairs == st.make_pair_indices(3)
    want = jmodel.infer_pairs(imgs, pairs, batch_size=4)
    got = tmodel.infer_pairs(imgs, pairs, batch_size=4)
    assert [(p.idx1, p.idx2) for p in got] == pairs
    for pw, pg in zip(want, got):
        for key in ("pts2", "conf1", "desc2"):
            np.testing.assert_allclose(getattr(pg, key).numpy(),
                                       getattr(pw, key),
                                       atol=OUT_ATOL[key], rtol=2e-3)


@pytest.mark.parametrize("shape", [(1, 1, 2, 4), (1, 1, 8, 7), (3, 1, 5, 1),
                                   (4, 6, 4, 6), (2, 3, 1, 9)])
def test_resize_align_corners_matches_jax(shape):
    """Bilinear align_corners=True resize, including the one-sample axes
    where the JAX interpolation matrix averages."""
    h, w, oh, ow = shape
    x = np.random.default_rng(5).normal(size=(2, h, w, 3)).astype(np.float32)
    want = np.asarray(jheads._resize_align_corners(jnp.asarray(x), oh, ow))
    got = theads._resize_align_corners(
        torch.from_numpy(x).permute(0, 3, 1, 2), oh, ow).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


def test_rope_matches_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    k = rng.normal(size=(2, 12, 3, 16)).astype(np.float32)
    pos = np.stack(np.meshgrid(np.arange(3), np.arange(4), indexing="ij"),
                   -1).reshape(1, 12, 2)
    jc, js = jrope.rope_2d_freqs(jnp.asarray(pos), 16)
    jq, jk = jrope.apply_rope_2d(jnp.asarray(q), jnp.asarray(k), jc, js)
    tc, ts = trope.rope_2d_freqs(torch.from_numpy(pos), 16)
    tq, tk = trope.apply_rope_2d(torch.from_numpy(q), torch.from_numpy(k),
                                 tc, ts)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)


def test_large_preset_has_checkpoint_layout():
    """At ModelConfig.large() the port's state dict holds exactly the
    public MASt3R_ViTLarge_BaseDecoder keys (fixture manifest) with the
    checkpoint's shapes. Built on the meta device: no memory."""
    import os
    from starst3r_tpu.io.torch_convert import synthetic_state_dict
    from starst3r_tpu_torch.models.mast3r import TwoViewNet
    with torch.device("meta"):
        net = TwoViewNet(stt.ModelConfig.large())
    manifest = os.path.join(os.path.dirname(__file__), "fixtures",
                            "mast3r_large_key_manifest.txt")
    with open(manifest) as f:
        want = [ln.strip() for ln in f if ln.strip()
                and not ln.startswith("#")]
    sd = net.state_dict()
    assert sorted(sd) == want
    ref = synthetic_state_dict(st.ModelConfig.large(), zeros=True)
    for k, v in sd.items():
        assert tuple(v.shape) == ref[k].shape, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_rope_attention_plain_is_rope_then_sdpa(kind, dtype):
    """On the CPU `rope_attention` is `apply_rope_2d` on q and on k, each
    with its own table, then `sdpa`, bit for bit, at 140 tokens (224 x 160),
    and counts the call."""
    from starst3r_tpu_torch.ops.attention import rope_attention, sdpa
    q, k, v, rope_q, rope_k = attention_inputs("cpu", 2, (10, 14), 3, 16,
                                               kind, dtype, seed=7)
    rq, _ = trope.apply_rope_2d(q, q, *rope_q)
    rk, _ = trope.apply_rope_2d(k, k, *rope_k)
    want = sdpa(rq, rk, v)
    before = rope_attention.launches
    got = rope_attention(q, k, v, rope_q, rope_k)
    assert rope_attention.launches == before + 1
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_full_depth_forward_counts_rope_attention_launches():
    """A forward at the large preset's depths (24 encoder blocks, 12 + 12
    decoder blocks; the tiny widths) makes one `rope_attention` call a
    block's attention, enc_depth + 4 dec_depth = 72, and none of the flash
    route's."""
    import dataclasses
    from starst3r_tpu_torch.ops import attention
    large = stt.ModelConfig.large()
    cfg = dataclasses.replace(stt.ModelConfig.tiny(),
                              enc_depth=large.enc_depth,
                              dec_depth=large.dec_depth)
    model = stt.Mast3rModel.init_random(cfg, seed=0, device="cpu")
    img = torch.rand(1, H, W, 3) * 2 - 1
    before = attention.rope_attention.launches
    flash = attention.fused_sdpa.launches
    model.infer_pair_batch(img, img.flip(2))
    assert attention.rope_attention.launches - before == 72
    assert attention.fused_sdpa.launches == flash
