"""Carry weights and state from the JAX package into the port.

The inputs are plain nested dicts / tuples of numpy arrays (what
``jax.device_get`` gives for the JAX package's pytrees), so this module needs
neither JAX nor the JAX package:

  - `mast3r_state_dict_from_jax`: flax params of the JAX `TwoViewNet` ->
    the port's `state_dict` (public MASt3R `.pth` key layout). The inverse of
    `starst3r_tpu/io/torch_convert.py::convert_state_dict`; the mapping is
    written out here.
  - `ga_params_from_jax`: a JAX `GAParams` (as numpy) -> the port's
    `GAParams`, for warm-start parity.
  - `gaussians_from_jax`: `GSState.params` -> the port's Gaussian params.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..alignment.ga import GAParams
from ..utils.device import resolve_device

__all__ = ("mast3r_state_dict_from_jax", "ga_params_from_jax",
           "gaussians_from_jax")


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


def mast3r_state_dict_from_jax(params: Mapping[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """JAX `TwoViewNet` params ({'params': {...}} or the inner dict) -> the
    port's `TwoViewNet.state_dict()`, float32 CPU tensors."""
    p = params["params"] if "params" in params else params
    enc, dec = p["encoder"], p["decoder"]
    sd: Dict[str, np.ndarray] = {}
    _conv(sd, "patch_embed.proj", enc["patch_embed"]["proj"])
    _ln(sd, "enc_norm", enc["norm"])
    enc_depth = sum(1 for k in enc if re.fullmatch(r"block\d+", k))
    for i in range(enc_depth):
        b = enc[f"block{i}"]
        _ln(sd, f"enc_blocks.{i}.norm1", b["norm1"])
        _ln(sd, f"enc_blocks.{i}.norm2", b["norm2"])
        _attn(sd, f"enc_blocks.{i}.attn", b["attn"])
        _mlp(sd, f"enc_blocks.{i}.mlp", b["mlp"])
    _dense(sd, "decoder_embed", dec["embed"])
    _ln(sd, "dec_norm", dec["norm"])
    dec_depth = sum(1 for k in dec if re.fullmatch(r"block\d+", k))
    for i in range(dec_depth):
        _dec_block(sd, f"dec_blocks.{i}", dec[f"block{i}"])
        _dec_block(sd, f"dec_blocks2.{i}", dec[f"block2_{i}"])
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
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


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
