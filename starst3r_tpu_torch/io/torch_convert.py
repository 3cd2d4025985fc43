"""The public MASt3R ``.pth`` state-dict layout -> the JAX package's flax
parameter tree (port of `starst3r_tpu/io/torch_convert.py`): the mapping
(`convert_state_dict`), a state dict of that layout at any geometry
(`synthetic_state_dict`), and the conversion of a ``.pth`` file into the
``.npz`` both packages' `from_pretrained` read (`convert_file`; run as
``python -m starst3r_tpu_torch.io.torch_convert PTH OUT``).

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

import argparse
from typing import Any, Dict, List, Tuple

import numpy as np

__all__ = ("convert_state_dict", "synthetic_state_dict", "convert_file",
           "main")


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


def synthetic_state_dict(cfg, zeros: bool = False, seed: int = 0
                         ) -> Dict[str, np.ndarray]:
    """A state dict with the public MASt3R checkpoint layout (key naming
    per mast3r/catmlp_dpt_head.py + croco lineage) at ``cfg`` geometry.

    Lets the converter be checked against the real checkpoint's key naming
    at any geometry, `ModelConfig.large()` (the published
    MASt3R_ViTLarge_BaseDecoder layout) included, without the 2 GB file.
    ``zeros=True`` allocates zero arrays (cheap at large geometry; naming
    and shape checks only).
    """
    rng = np.random.default_rng(seed)

    def arr(*shape):
        if zeros:
            return np.zeros(shape, np.float32)
        return rng.normal(size=shape).astype(np.float32)

    sd: Dict[str, np.ndarray] = {}

    def add(key, *shape):
        sd[key] = arr(*shape)

    p = cfg.patch_size
    add("patch_embed.proj.weight", cfg.enc_dim, 3, p, p)
    add("patch_embed.proj.bias", cfg.enc_dim)
    add("enc_norm.weight", cfg.enc_dim)
    add("enc_norm.bias", cfg.enc_dim)
    for i in range(cfg.enc_depth):
        pfx = f"enc_blocks.{i}"
        for n in ("norm1", "norm2"):
            add(f"{pfx}.{n}.weight", cfg.enc_dim)
            add(f"{pfx}.{n}.bias", cfg.enc_dim)
        add(f"{pfx}.attn.qkv.weight", 3 * cfg.enc_dim, cfg.enc_dim)
        add(f"{pfx}.attn.qkv.bias", 3 * cfg.enc_dim)
        add(f"{pfx}.attn.proj.weight", cfg.enc_dim, cfg.enc_dim)
        add(f"{pfx}.attn.proj.bias", cfg.enc_dim)
        hid = int(cfg.enc_dim * cfg.mlp_ratio)
        add(f"{pfx}.mlp.fc1.weight", hid, cfg.enc_dim)
        add(f"{pfx}.mlp.fc1.bias", hid)
        add(f"{pfx}.mlp.fc2.weight", cfg.enc_dim, hid)
        add(f"{pfx}.mlp.fc2.bias", cfg.enc_dim)

    dd = cfg.dec_dim
    add("decoder_embed.weight", dd, cfg.enc_dim)
    add("decoder_embed.bias", dd)
    add("dec_norm.weight", dd)
    add("dec_norm.bias", dd)
    for blocks in ("dec_blocks", "dec_blocks2"):
        for i in range(cfg.dec_depth):
            pfx = f"{blocks}.{i}"
            for n in ("norm1", "norm2", "norm3", "norm_y"):
                add(f"{pfx}.{n}.weight", dd)
                add(f"{pfx}.{n}.bias", dd)
            add(f"{pfx}.attn.qkv.weight", 3 * dd, dd)
            add(f"{pfx}.attn.qkv.bias", 3 * dd)
            add(f"{pfx}.attn.proj.weight", dd, dd)
            add(f"{pfx}.attn.proj.bias", dd)
            for n in ("projq", "projk", "projv", "proj"):
                add(f"{pfx}.cross_attn.{n}.weight", dd, dd)
                add(f"{pfx}.cross_attn.{n}.bias", dd)
            hid = int(dd * cfg.mlp_ratio)
            add(f"{pfx}.mlp.fc1.weight", hid, dd)
            add(f"{pfx}.mlp.fc1.bias", hid)
            add(f"{pfx}.mlp.fc2.weight", dd, hid)
            add(f"{pfx}.mlp.fc2.bias", dd)

    fd = cfg.dpt_feature_dim
    ld = cfg.dpt_layer_dims
    last = cfg.dpt_last_dim
    idim = cfg.enc_dim + dd
    dims_tokens = (cfg.enc_dim, dd, dd, dd)
    for v in ("1", "2"):
        dpt = f"downstream_head{v}.dpt"
        for i in range(4):
            add(f"{dpt}.act_postprocess.{i}.0.weight",
                ld[i], dims_tokens[i], 1, 1)
            add(f"{dpt}.act_postprocess.{i}.0.bias", ld[i])
        add(f"{dpt}.act_postprocess.0.1.weight", ld[0], ld[0], 4, 4)
        add(f"{dpt}.act_postprocess.0.1.bias", ld[0])
        add(f"{dpt}.act_postprocess.1.1.weight", ld[1], ld[1], 2, 2)
        add(f"{dpt}.act_postprocess.1.1.bias", ld[1])
        add(f"{dpt}.act_postprocess.3.1.weight", ld[3], ld[3], 3, 3)
        add(f"{dpt}.act_postprocess.3.1.bias", ld[3])
        for j in range(1, 5):
            add(f"{dpt}.scratch.layer{j}_rn.weight", fd, ld[j - 1], 3, 3)
            rp = f"{dpt}.scratch.refinenet{j}"
            for unit in ("resConfUnit1", "resConfUnit2"):
                for conv in ("conv1", "conv2"):
                    add(f"{rp}.{unit}.{conv}.weight", fd, fd, 3, 3)
                    add(f"{rp}.{unit}.{conv}.bias", fd)
            add(f"{rp}.out_conv.weight", fd, fd, 1, 1)
            add(f"{rp}.out_conv.bias", fd)
        add(f"{dpt}.head.0.weight", fd // 2, fd, 3, 3)
        add(f"{dpt}.head.0.bias", fd // 2)
        add(f"{dpt}.head.2.weight", last, fd // 2, 3, 3)
        add(f"{dpt}.head.2.bias", last)
        add(f"{dpt}.head.4.weight", 4, last, 1, 1)
        add(f"{dpt}.head.4.bias", 4)
        lf = f"downstream_head{v}.head_local_features"
        hid = int(cfg.desc_hidden_factor * idim)
        add(f"{lf}.fc1.weight", hid, idim)
        add(f"{lf}.fc1.bias", hid)
        add(f"{lf}.fc2.weight", (cfg.desc_dim + 1) * p * p, hid)
        add(f"{lf}.fc2.bias", (cfg.desc_dim + 1) * p * p)

    add("mask_token", 1, 1, dd)
    return sd


def _overwrite(dst: Dict[str, Any], src: Dict[str, Any], path: str = ""
               ) -> List[str]:
    """Write every leaf of ``src`` into ``dst`` where ``dst`` has a leaf of
    that shape; return the others, named as the JAX package names them."""
    bad = []
    for k, v in src.items():
        if isinstance(v, dict):
            if k in dst and isinstance(dst[k], dict):
                bad += _overwrite(dst[k], v, f"{path}/{k}")
            else:
                bad.append(f"{path}/{k} (missing in target)")
        elif k in dst and tuple(np.shape(dst[k])) == tuple(v.shape):
            dst[k] = np.asarray(v, np.float32)
        else:
            have = tuple(np.shape(dst.get(k, ()))) if k in dst else None
            bad.append(f"{path}/{k} shape {v.shape} vs {have}")
    return bad


def convert_file(pth_path: str, out_path: str, preset: str = "large",
                 verbose: bool = True, device="cuda") -> List[str]:
    """Convert a public MASt3R ``.pth`` checkpoint into the ``.npz`` of
    `Mast3rModel.save_pretrained` at the geometry of ``preset``.

    Every leaf the mapping fills is the checkpoint's; the others keep a
    random initialisation (seed 0, made on ``device``). Returns the leaves
    whose shape did not match and the checkpoint keys nothing mapped, as
    the JAX package's `convert_file` does."""
    import torch

    from ..config import model_preset
    from ..models.mast3r import Mast3rModel
    from .from_jax import mast3r_state_dict_from_jax

    # a full training checkpoint pickles more than tensors; load only
    # files from a source you trust
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    cfg = model_preset(preset)
    mapped, unmapped = convert_state_dict(sd, cfg.enc_depth, cfg.dec_depth,
                                          cfg.patch_size, cfg.desc_dim)
    model = Mast3rModel.init_random(cfg, seed=0, device=device)
    params, _ = convert_state_dict(
        {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
        cfg.enc_depth, cfg.dec_depth, cfg.patch_size, cfg.desc_dim)
    mismatches = _overwrite(params["params"], mapped["params"])
    model.load_state_dict({k: v.to(model.device) for k, v in
                           mast3r_state_dict_from_jax(params).items()})
    model.save_pretrained(out_path)
    if verbose:
        print(f"converted -> {out_path}")
        if mismatches:
            print(f"{len(mismatches)} mismatched leaves (first 10):")
            for m in mismatches[:10]:
                print("  ", m)
        if unmapped:
            print(f"{len(unmapped)} unmapped torch keys (first 10):")
            for m in unmapped[:10]:
                print("  ", m)
        if not mismatches and not unmapped:
            print("all keys mapped (trunk + DPT + descriptor heads)")
    return mismatches + unmapped


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="convert public MASt3R .pth weights to .npz")
    ap.add_argument("pth")
    ap.add_argument("out")
    ap.add_argument("--preset", default="large")
    ap.add_argument("--device", default="cuda",
                    help="where the random initialisation of the unmapped "
                    "leaves is made (cuda unless cpu)")
    args = ap.parse_args(argv)
    convert_file(args.pth, args.out, args.preset, device=args.device)


if __name__ == "__main__":
    main()
