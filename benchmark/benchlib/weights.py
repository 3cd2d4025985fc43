"""The network's weights, made on the device from the seed: one normal draw
for every weight in one call, each weight scaled by 1/sqrt(fan-in) (the
lecun-normal scale), biases 0, LayerNorms 1 and 0, the weights the forward
never reads 0. Float32, as the program holds them (it runs them under
bfloat16 autocast). The reference and the program get the same tensors."""

from __future__ import annotations

import math
from typing import Dict

from reference.network import fan_in, layout


def make_weights(cfg: dict, seed: int, device) -> Dict:
    import torch
    lay = layout(cfg)
    n = sum(math.prod(shape) for _, shape, kind in lay if kind == "weight")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for key, shape, kind in lay:
        size = math.prod(shape)
        if kind == "weight":
            w = flat[off:off + size].view(shape)
            w.mul_(1.0 / math.sqrt(fan_in(key, shape)))
            off += size
        elif kind == "ln_w":
            w = torch.ones(shape, device=device)
        else:
            w = torch.zeros(shape, device=device)
        out[key] = w
    return out


def model_config(cfg: dict):
    """The program's `ModelConfig` for a configuration file."""
    from starst3r_tpu_torch.config import ModelConfig
    return ModelConfig(
        name=cfg["name"], patch_size=cfg["patch_size"],
        enc_depth=cfg["enc_depth"], enc_dim=cfg["enc_embed_dim"],
        enc_heads=cfg["enc_num_heads"], dec_depth=cfg["dec_depth"],
        dec_dim=cfg["dec_embed_dim"], dec_heads=cfg["dec_num_heads"],
        desc_dim=cfg["local_feat_dim"], rope_base=cfg["rope_base"],
        mlp_ratio=cfg["mlp_ratio"], dtype=cfg["dtype"],
        pointmap_mode=cfg["depth_mode"],
        dpt_feature_dim=cfg["dpt_feature_dim"],
        dpt_layer_dims=tuple(cfg["dpt_layer_dims"]),
        dpt_last_dim=cfg["dpt_last_dim"],
        desc_hidden_factor=cfg["desc_hidden_factor"])


def build_model(cfg: dict, weights: Dict, device):
    """The program's model with ``weights`` loaded (a copy: the caller may
    free its own)."""
    import torch
    from starst3r_tpu_torch.models.mast3r import Mast3rModel, TwoViewNet
    mcfg = model_config(cfg)
    with torch.device("meta"):
        net = TwoViewNet(mcfg)
    net = net.to_empty(device=device)
    net.load_state_dict(weights, strict=True)
    return Mast3rModel(mcfg, net, device)
