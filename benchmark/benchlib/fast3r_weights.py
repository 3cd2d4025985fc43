"""Fast3R's weights, made on the device from the seed, and the program's
model built on them: one normal draw for every drawn tensor in one call,
each scaled by 1/sqrt(fan-in), the fusion blocks' q and k rows of ``qkv``
by `QK_GAIN` more (`reference.fast3r.layout`), biases 0, LayerNorms 1 and
0, the weights the forward never reads 0. Float32, as the program holds
them. The reference and the program get the same tensors."""

from __future__ import annotations

import math
from typing import Dict

from reference.fast3r import QK_GAIN, fan_in, layout

DRAWN = ("weight", "qk_weight")


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
            w.mul_(1.0 / math.sqrt(fan_in(key, shape)))
            if kind == "qk_weight":
                w[:2 * shape[1]].mul_(QK_GAIN)
            off += size
        elif kind == "ln_w":
            w = torch.ones(shape, device=device)
        else:
            w = torch.zeros(shape, device=device)
        out[key] = w
    return out


def model_config(cfg: dict):
    """The program's `Fast3RConfig` for a configuration file."""
    from starst3r_tpu_torch.config import Fast3RConfig
    return Fast3RConfig(
        name=cfg["name"], patch_size=cfg["patch_size"],
        enc_depth=cfg["enc_depth"], enc_dim=cfg["enc_embed_dim"],
        enc_heads=cfg["enc_num_heads"], dec_depth=cfg["dec_depth"],
        dec_dim=cfg["dec_embed_dim"], dec_heads=cfg["dec_num_heads"],
        mlp_ratio=cfg["mlp_ratio"], rope_base=cfg["rope_base"],
        pointmap_mode=cfg["depth_mode"],
        dpt_feature_dim=cfg["dpt_feature_dim"],
        dpt_layer_dims=tuple(cfg["dpt_layer_dims"]),
        dpt_last_dim=cfg["dpt_last_dim"], enc_chunk=cfg["enc_chunk"],
        heads_chunk=cfg["heads_chunk"], dtype=cfg["dtype"])


def build_model(cfg: dict, weights: Dict, device):
    """The program's Fast3R with ``weights`` loaded (a copy: the caller
    may free its own)."""
    import torch
    from starst3r_tpu_torch.models.fast3r import Fast3RModel, Fast3RNet
    fcfg = model_config(cfg)
    with torch.device("meta"):
        net = Fast3RNet(fcfg)
    net = net.to_empty(device=device)
    net.load_state_dict(weights, strict=True)
    return Fast3RModel(fcfg, net, device)
