"""The public MASt3R ``.pth`` state-dict layout -> the JAX package's flax
parameter tree (port of the mapping half of
`starst3r_tpu/io/torch_convert.py`; numpy only: no CLI, no `.pth` loading).

The port's `TwoViewNet.state_dict()` has the ``.pth`` layout
(patch_embed / enc_blocks / enc_norm / decoder_embed / dec_blocks /
dec_blocks2 / dec_norm / downstream_head{1,2} with the catmlpdpt heads), so
this mapping is what `Mast3rModel.save_pretrained` needs to write the JAX
package's checkpoint format. `io/from_jax.py::mast3r_state_dict_from_jax`
is its inverse.

Layout details (mast3r catmlp_dpt_head.py, croco dpt_block.py):
  - non-overlapping transposed convs (kernel == stride) become the
    Dense + pixel-shuffle form of the flax head: kernel (in, out, r, r) ->
    (in, r*r*out) in (dy, dx, o) column order, bias tiled per sub-pixel;
  - the descriptor MLP's fc2 columns are permuted from torch pixel_shuffle's
    (c, i, j) channel order to the flax (i, j, c) order;
  - `mask_token` (croco's masked-pretraining token) and
    `refinenet4.resConfUnit1.*` (refinenet4 takes no skip input) are dead
    at inference: acknowledged, not mapped.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ("convert_state_dict",)


class _Rec:
    """state_dict wrapper that records which keys the mapping consumed."""

    def __init__(self, sd: Dict[str, Any]):
        self.sd = sd
        self.used = set()

    def __getitem__(self, key):
        self.used.add(key)
        return self.sd[key]

    def __contains__(self, key):
        return key in self.sd

    def mark(self, key):
        if key in self.sd:
            self.used.add(key)


def _t(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x)


def _dense(sd, key):
    """torch Linear (out,in) -> flax Dense {kernel (in,out), bias}."""
    out = {"kernel": _t(sd[f"{key}.weight"]).T}
    if f"{key}.bias" in sd:
        out["bias"] = _t(sd[f"{key}.bias"])
    return out


def _ln(sd, key):
    return {"scale": _t(sd[f"{key}.weight"]), "bias": _t(sd[f"{key}.bias"])}


def _conv(sd, key, bias=True):
    """torch Conv2d (out,in,kh,kw) -> flax Conv {kernel (kh,kw,in,out)}."""
    w = _t(sd[f"{key}.weight"])
    out = {"kernel": w.transpose(2, 3, 1, 0)}
    if bias:
        out["bias"] = _t(sd[f"{key}.bias"])
    return out


def _conv1x1_as_dense(sd, key):
    w = _t(sd[f"{key}.weight"])          # (out, in, 1, 1)
    return {"kernel": w[:, :, 0, 0].T, "bias": _t(sd[f"{key}.bias"])}


def _convT_as_dense_up(sd, key, r):
    """Non-overlapping ConvTranspose (in,out,r,r) -> Dense+pixel-shuffle:
    kernel (in, r*r*out) with (dy, dx, o) column order, bias tiled."""
    w = _t(sd[f"{key}.weight"])          # (in, out, r, r)
    k = w.transpose(0, 2, 3, 1).reshape(w.shape[0], -1)
    b = np.tile(_t(sd[f"{key}.bias"]), r * r)
    return {"dense": {"kernel": k, "bias": b}}


def _fc_pixelshuffle(sd, key, p, out_ch):
    """torch Mlp.fc2 whose output feeds F.pixel_shuffle (channel order
    c*p*p + i*p + j) -> the flax (i*p + j)*C + c shuffle order."""
    w = _t(sd[f"{key}.weight"])          # (C*p*p, in)
    b = _t(sd[f"{key}.bias"])
    perm = (np.arange(out_ch * p * p).reshape(out_ch, p, p)
            .transpose(1, 2, 0).reshape(-1))
    return {"kernel": w.T[:, perm], "bias": b[perm]}


def _enc_block(sd, i):
    p = f"enc_blocks.{i}"
    return {
        "norm1": _ln(sd, f"{p}.norm1"),
        "norm2": _ln(sd, f"{p}.norm2"),
        "attn": {"qkv": _dense(sd, f"{p}.attn.qkv"),
                 "proj": _dense(sd, f"{p}.attn.proj")},
        "mlp": {"fc1": _dense(sd, f"{p}.mlp.fc1"),
                "fc2": _dense(sd, f"{p}.mlp.fc2")},
    }


def _dec_block(sd, prefix, i):
    p = f"{prefix}.{i}"
    blk = {
        "norm1": _ln(sd, f"{p}.norm1"),
        "norm2": _ln(sd, f"{p}.norm2"),
        "norm3": _ln(sd, f"{p}.norm3"),
        # croco norm_mem=True: LayerNorm on the cross-attention memory
        "norm_y": _ln(sd, f"{p}.norm_y"),
        "self_attn": {"qkv": _dense(sd, f"{p}.attn.qkv"),
                      "proj": _dense(sd, f"{p}.attn.proj")},
        "mlp": {"fc1": _dense(sd, f"{p}.mlp.fc1"),
                "fc2": _dense(sd, f"{p}.mlp.fc2")},
    }
    # CroCo cross attention: projq/projk/projv/proj
    blk["cross_attn"] = {
        "q": _dense(sd, f"{p}.cross_attn.projq"),
        "k": _dense(sd, f"{p}.cross_attn.projk"),
        "v": _dense(sd, f"{p}.cross_attn.projv"),
        "proj": _dense(sd, f"{p}.cross_attn.proj"),
    }
    return blk


def _dpt_head(sd, pfx):
    d: Dict[str, Any] = {}
    for i in range(4):
        d[f"act{i}_proj"] = _conv1x1_as_dense(
            sd, f"{pfx}.act_postprocess.{i}.0")
    d["act0_up"] = _convT_as_dense_up(sd, f"{pfx}.act_postprocess.0.1", 4)
    d["act1_up"] = _convT_as_dense_up(sd, f"{pfx}.act_postprocess.1.1", 2)
    d["act3_down"] = _conv(sd, f"{pfx}.act_postprocess.3.1")
    for j in range(1, 5):
        d[f"layer{j}_rn"] = _conv(sd, f"{pfx}.scratch.layer{j}_rn",
                                  bias=False)
    for j in range(1, 5):
        rp = f"{pfx}.scratch.refinenet{j}"
        r: Dict[str, Any] = {}
        if j != 4:
            r["res1"] = {"conv1": _conv(sd, f"{rp}.resConfUnit1.conv1"),
                         "conv2": _conv(sd, f"{rp}.resConfUnit1.conv2")}
        else:
            # refinenet4 gets no skip input: torch allocates resConfUnit1
            # anyway; acknowledge the dead weights
            for leaf in ("conv1.weight", "conv1.bias",
                         "conv2.weight", "conv2.bias"):
                sd.mark(f"{rp}.resConfUnit1.{leaf}")
        r["res2"] = {"conv1": _conv(sd, f"{rp}.resConfUnit2.conv1"),
                     "conv2": _conv(sd, f"{rp}.resConfUnit2.conv2")}
        r["out_conv"] = _conv(sd, f"{rp}.out_conv")
        d[f"refinenet{j}"] = r
    d["head0"] = _conv(sd, f"{pfx}.head.0")
    d["head2"] = _conv(sd, f"{pfx}.head.2")
    d["head4"] = _conv(sd, f"{pfx}.head.4")
    return d


def convert_state_dict(sd: Dict[str, Any], enc_depth: int, dec_depth: int,
                       patch_size: int = 16, desc_dim: int = 24,
                       ) -> Tuple[Dict[str, Any], List[str]]:
    """Returns (flax params {'params': ...}, unmapped torch keys).

    Maps the full trunk AND the catmlpdpt heads (DPT pointmap head +
    head_local_features descriptor MLP). A correct MASt3R checkpoint layout
    yields zero unmapped keys.
    """
    rec = _Rec(sd)
    params: Dict[str, Any] = {}

    # encoder
    enc = {"patch_embed": {"proj": _conv(rec, "patch_embed.proj")},
           "norm": _ln(rec, "enc_norm")}
    for i in range(enc_depth):
        enc[f"block{i}"] = _enc_block(rec, i)
    params["encoder"] = enc

    # interleaved decoder: ONE shared decoder_embed + dec_norm, two block
    # stacks (dec_blocks -> block{i} for view 1, dec_blocks2 -> block2_{i}
    # for view 2) run in lockstep (the JAX package's InterleavedDecoder)
    dec = {"embed": _dense(rec, "decoder_embed"),
           "norm": _ln(rec, "dec_norm")}
    for i in range(dec_depth):
        dec[f"block{i}"] = _dec_block(rec, "dec_blocks", i)
        dec[f"block2_{i}"] = _dec_block(rec, "dec_blocks2", i)
    params["decoder"] = dec

    # heads
    for view in ("1", "2"):
        hp = f"downstream_head{view}"
        if f"{hp}.dpt.head.0.weight" in sd:
            params[f"head{view}"] = _dpt_head(rec, f"{hp}.dpt")
        if f"{hp}.head_local_features.fc1.weight" in sd:
            params[f"desc_head{view}"] = {
                "fc1": _dense(rec, f"{hp}.head_local_features.fc1"),
                "fc2": _fc_pixelshuffle(
                    rec, f"{hp}.head_local_features.fc2",
                    patch_size, desc_dim + 1),
            }

    # acknowledged dead weights
    rec.mark("mask_token")

    unmapped = sorted(k for k in sd if k not in rec.used)
    return {"params": params}, unmapped
