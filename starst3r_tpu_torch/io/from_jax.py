"""Carry weights and state from the JAX package into the port.

The inputs are plain nested dicts / tuples of numpy arrays (what
``jax.device_get`` gives for the JAX package's pytrees), so this module needs
neither JAX nor the JAX package:

  - `mast3r_state_dict_from_jax`: flax params of the JAX `TwoViewNet` ->
    the port's `state_dict` (public MASt3R `.pth` key layout). The inverse of
    `starst3r_tpu/io/torch_convert.py::convert_state_dict`; the mapping is
    written out here.
  - `encoder_state_dict_from_jax`, `decoder_state_dict_from_jax`: the
    params of the JAX `Encoder` / `InterleavedDecoder` modules -> the
    port's `models.vit.Encoder` / `InterleavedDecoder` state dicts.
  - `ga_params_from_jax`: a JAX `GAParams` (as numpy) -> the port's
    `GAParams`, for warm-start parity.
  - `gaussians_from_jax`: `GSState.params` -> the port's Gaussian params.
  - `gs_state_from_jax`: a whole JAX `GSState` -> the port's, for training
    parity: params, the Adam count and moments, step and n_alive.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..alignment.ga import GAParams
from ..splat.train import AdamState, GSState
from ..utils.device import resolve_device

__all__ = ("mast3r_state_dict_from_jax", "encoder_state_dict_from_jax",
           "decoder_state_dict_from_jax", "ga_params_from_jax",
           "gaussians_from_jax", "gs_state_from_jax")


def _np(x) -> np.ndarray:
    return np.array(x, np.float32)   # a writable copy


def _dense(sd, key, p):
    """flax Dense {kernel (in,out), bias} -> torch Linear (out, in)."""
    sd[f"{key}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        sd[f"{key}.bias"] = _np(p["bias"])


def _ln(sd, key, p):
    sd[f"{key}.weight"] = _np(p["scale"])
    sd[f"{key}.bias"] = _np(p["bias"])


def _conv(sd, key, p):
    """flax Conv kernel (kh, kw, in, out) -> torch (out, in, kh, kw)."""
    sd[f"{key}.weight"] = _np(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[f"{key}.bias"] = _np(p["bias"])


def _dense_as_conv1x1(sd, key, p):
    sd[f"{key}.weight"] = _np(p["kernel"]).T[:, :, None, None]
    sd[f"{key}.bias"] = _np(p["bias"])


def _dense_up_as_convT(sd, key, p, r):
    """Dense + pixel-shuffle kernel (in, r*r*out) in (dy, dx, o) column
    order -> ConvTranspose2d weight (in, out, r, r); bias untiled."""
    k = _np(p["dense"]["kernel"])
    cin = k.shape[0]
    out = k.shape[1] // (r * r)
    sd[f"{key}.weight"] = k.reshape(cin, r, r, out).transpose(0, 3, 1, 2)
    sd[f"{key}.bias"] = _np(p["dense"]["bias"])[:out]


def _pixelshuffle_fc(sd, key, p, patch, out_ch):
    """fc2 in the JAX (i*p + j)*C + c column order -> torch pixel_shuffle's
    c*p*p + i*p + j row order."""
    perm = (np.arange(out_ch * patch * patch).reshape(out_ch, patch, patch)
            .transpose(1, 2, 0).reshape(-1))
    inv = np.argsort(perm)
    sd[f"{key}.weight"] = _np(p["kernel"])[:, inv].T
    sd[f"{key}.bias"] = _np(p["bias"])[inv]


def _attn(sd, key, p):
    _dense(sd, f"{key}.qkv", p["qkv"])
    _dense(sd, f"{key}.proj", p["proj"])


def _mlp(sd, key, p):
    _dense(sd, f"{key}.fc1", p["fc1"])
    _dense(sd, f"{key}.fc2", p["fc2"])


def _dec_block(sd, key, p):
    for n in ("norm1", "norm2", "norm3", "norm_y"):
        _ln(sd, f"{key}.{n}", p[n])
    _attn(sd, f"{key}.attn", p["self_attn"])
    for src, dst in (("q", "projq"), ("k", "projk"), ("v", "projv"),
                     ("proj", "proj")):
        _dense(sd, f"{key}.cross_attn.{dst}", p["cross_attn"][src])
    _mlp(sd, f"{key}.mlp", p["mlp"])


def _dpt(sd, key, p):
    for i in range(4):
        _dense_as_conv1x1(sd, f"{key}.act_postprocess.{i}.0",
                          p[f"act{i}_proj"])
    _dense_up_as_convT(sd, f"{key}.act_postprocess.0.1", p["act0_up"], 4)
    _dense_up_as_convT(sd, f"{key}.act_postprocess.1.1", p["act1_up"], 2)
    _conv(sd, f"{key}.act_postprocess.3.1", p["act3_down"])
    fd = None
    for j in range(1, 5):
        _conv(sd, f"{key}.scratch.layer{j}_rn", p[f"layer{j}_rn"])
        rp = f"{key}.scratch.refinenet{j}"
        r = p[f"refinenet{j}"]
        for unit, name in (("res1", "resConfUnit1"), ("res2", "resConfUnit2")):
            if unit in r:
                _conv(sd, f"{rp}.{name}.conv1", r[unit]["conv1"])
                _conv(sd, f"{rp}.{name}.conv2", r[unit]["conv2"])
        _conv(sd, f"{rp}.out_conv", r["out_conv"])
        fd = _np(r["out_conv"]["bias"]).shape[0]
    # refinenet4 takes no skip input: its resConfUnit1 is dead weight the
    # checkpoint carries and the JAX model does not have
    rp = f"{key}.scratch.refinenet4.resConfUnit1"
    for conv in ("conv1", "conv2"):
        sd[f"{rp}.{conv}.weight"] = np.zeros((fd, fd, 3, 3), np.float32)
        sd[f"{rp}.{conv}.bias"] = np.zeros((fd,), np.float32)
    for idx in (0, 2, 4):
        _conv(sd, f"{key}.head.{idx}", p[f"head{idx}"])


def _n_blocks(p: Mapping[str, Any], prefix: str) -> int:
    return sum(1 for k in p if re.fullmatch(prefix + r"\d+", k))


def _encoder(sd, p, embed: str, blocks: str, norm: str):
    """The JAX `Encoder`'s params (patch_embed, block{i}, norm) under the
    port's names ``embed``, ``blocks.{i}``, ``norm``."""
    _conv(sd, f"{embed}.proj", p["patch_embed"]["proj"])
    _ln(sd, norm, p["norm"])
    for i in range(_n_blocks(p, "block")):
        b = p[f"block{i}"]
        _ln(sd, f"{blocks}.{i}.norm1", b["norm1"])
        _ln(sd, f"{blocks}.{i}.norm2", b["norm2"])
        _attn(sd, f"{blocks}.{i}.attn", b["attn"])
        _mlp(sd, f"{blocks}.{i}.mlp", b["mlp"])


def _decoder(sd, p, embed: str, blocks: str, blocks2: str, norm: str):
    """The JAX `InterleavedDecoder`'s params (embed, block{i}, block2_{i},
    norm) under the port's names."""
    _dense(sd, embed, p["embed"])
    _ln(sd, norm, p["norm"])
    for i in range(_n_blocks(p, "block")):
        _dec_block(sd, f"{blocks}.{i}", p[f"block{i}"])
        _dec_block(sd, f"{blocks2}.{i}", p[f"block2_{i}"])


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def _inner(params: Mapping[str, Any]) -> Mapping[str, Any]:
    return params["params"] if "params" in params else params


def encoder_state_dict_from_jax(params: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """JAX `models.vit.Encoder` params ({'params': {...}} or the inner
    dict) -> the port's `models.vit.Encoder` state dict."""
    sd: Dict[str, np.ndarray] = {}
    _encoder(sd, _inner(params), "patch_embed", "blocks", "norm")
    return _tensors(sd)


def decoder_state_dict_from_jax(params: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """JAX `models.vit.InterleavedDecoder` params -> the port's
    `models.vit.InterleavedDecoder` state dict."""
    sd: Dict[str, np.ndarray] = {}
    _decoder(sd, _inner(params), "embed", "blocks", "blocks2", "norm")
    return _tensors(sd)


def mast3r_state_dict_from_jax(params: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """JAX `TwoViewNet` params ({'params': {...}} or the inner dict) -> the
    port's `TwoViewNet.state_dict()`, float32 CPU tensors."""
    p = _inner(params)
    enc, dec = p["encoder"], p["decoder"]
    sd: Dict[str, np.ndarray] = {}
    _encoder(sd, enc, "patch_embed", "enc_blocks", "enc_norm")
    _decoder(sd, dec, "decoder_embed", "dec_blocks", "dec_blocks2",
             "dec_norm")
    patch = _np(enc["patch_embed"]["proj"]["kernel"]).shape[0]
    for v in ("1", "2"):
        _dpt(sd, f"downstream_head{v}.dpt", p[f"head{v}"])
        dh = p[f"desc_head{v}"]
        lf = f"downstream_head{v}.head_local_features"
        _dense(sd, f"{lf}.fc1", dh["fc1"])
        out_ch = _np(dh["fc2"]["kernel"]).shape[1] // (patch * patch)
        _pixelshuffle_fc(sd, f"{lf}.fc2", dh["fc2"], patch, out_ch)
    dec_dim = _np(dec["embed"]["kernel"]).shape[1]
    sd["mask_token"] = np.zeros((1, 1, dec_dim), np.float32)
    return _tensors(sd)


def ga_params_from_jax(params, device="cuda") -> GAParams:
    """A JAX `GAParams` (any sequence of 6 arrays in field order) -> the
    port's `GAParams` on ``device`` (the card unless "cpu")."""
    dev = resolve_device(device)
    return GAParams(*[torch.as_tensor(_np(x), device=dev) for x in params])


def gaussians_from_jax(params: Mapping[str, Any], device="cuda"
                       ) -> Dict[str, torch.Tensor]:
    """`GSState.params` (means, quats, scales, opacities, sh0, shN) -> the
    port's Gaussian parameter dict on ``device`` (the card unless "cpu")."""
    dev = resolve_device(device)
    keys = ("means", "quats", "scales", "opacities", "sh0", "shN")
    return {k: torch.as_tensor(_np(params[k]), device=dev) for k in keys}


def _field(x, name: str, index: int):
    """A NamedTuple's field by name, or by position in a plain tuple."""
    return getattr(x, name) if hasattr(x, name) else x[index]


def gs_state_from_jax(state, device="cuda", seed: int = 0) -> GSState:
    """A JAX `GSState` (params, optax.adam state (ScaleByAdamState(count,
    mu, nu), EmptyState), step, key, n_alive), as arrays or as numpy, ->
    the port's `GSState` on ``device`` (the card unless "cpu").

    The JAX PRNG key is not carried across: a key and a torch.Generator
    give different numbers from one seed, so the port's generator is seeded
    from ``seed`` instead."""
    dev = resolve_device(device)
    adam = _field(state, "opt_state", 1)[0]
    count = int(np.asarray(_field(adam, "count", 0)))
    mu = gaussians_from_jax(_field(adam, "mu", 1), device=dev)
    nu = gaussians_from_jax(_field(adam, "nu", 2), device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return GSState(params=gaussians_from_jax(_field(state, "params", 0),
                                             device=dev),
                   opt_state=AdamState(count, mu, nu),
                   step=int(np.asarray(_field(state, "step", 2))),
                   generator=gen,
                   n_alive=int(np.asarray(_field(state, "n_alive", 4))))
