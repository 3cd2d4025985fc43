"""VGGT's weights, made on the device from the seed, and the program's
model built on them: one normal draw for every drawn tensor in one call,
each scaled as `reference.vggt.layout` says (1/sqrt(fan-in) for weights,
1 for the tokens and the position table, 0.1/sqrt(fan-in) for the pose
branch's last layer), the others set by their kind (the qk-norm's weight
`QK_GAIN`). Float32, as the
program holds them. The reference and the program get the same tensors.
(`weights.py` is MASt3R's.)"""

from __future__ import annotations

import math
from typing import Dict

from reference.vggt import POSE_BIAS, QK_GAIN, fan_in, layout

DRAWN = ("weight", "token", "pose_w")


def make_weights(cfg: dict, seed: int, device) -> Dict:
    import torch
    lay = layout(cfg)
    n = sum(math.prod(shape) for _, shape, kind in lay if kind in DRAWN)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for key, shape, kind in lay:
        size = math.prod(shape)
        if kind in DRAWN:
            w = flat[off:off + size].view(shape)
            if kind != "token":
                w.mul_((0.1 if kind == "pose_w" else 1.0)
                       / math.sqrt(fan_in(key, shape)))
            off += size
        elif kind in ("ln_w", "gamma"):
            w = torch.ones(shape, device=device)
        elif kind == "qk_w":
            w = torch.full(shape, QK_GAIN, device=device)
        elif kind == "pose_b":
            w = torch.tensor(POSE_BIAS, device=device)
        else:
            w = torch.zeros(shape, device=device)
        out[key] = w
    return out


def model_config(cfg: dict):
    """The program's `VGGTConfig` for a configuration file."""
    from starst3r_tpu_torch.config import VGGTConfig
    return VGGTConfig(
        name=cfg["name"], patch_size=cfg["patch_size"],
        img_size=cfg["img_size"], enc_depth=cfg["enc_depth"],
        dim=cfg["embed_dim"], heads=cfg["num_heads"],
        mlp_ratio=cfg["mlp_ratio"],
        num_register_tokens=cfg["num_register_tokens"], depth=cfg["depth"],
        rope_base=float(cfg["rope_freq"]),
        head_layers=tuple(cfg["head_layers"]),
        dpt_feature_dim=cfg["dpt_features"],
        dpt_layer_dims=tuple(cfg["dpt_out_channels"]),
        dpt_last_dim=cfg["dpt_last_dim"],
        frames_chunk=cfg["frames_chunk_size"],
        camera_depth=cfg["camera_trunk_depth"],
        camera_heads=cfg["camera_num_heads"],
        camera_iters=cfg["camera_iterations"], dtype=cfg["dtype"])


def build_model(cfg: dict, weights: Dict, device):
    """The program's VGGT with ``weights`` loaded (a copy: the caller may
    free its own)."""
    import torch
    from starst3r_tpu_torch.models.vggt import VGGTModel, VGGTNet
    vcfg = model_config(cfg)
    with torch.device("meta"):
        net = VGGTNet(vcfg)
    net = net.to_empty(device=device)
    net.load_state_dict(weights, strict=True)
    net.aggregator.reset_buffers()
    return VGGTModel(vcfg, net, device)
