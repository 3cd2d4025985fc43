"""The asymmetric two-view pointmap + descriptor network and its user-facing
wrapper `Mast3rModel` (port of `starst3r_tpu/models/mast3r.py`).

Given an image pair (I1, I2): pointmaps of both images in I1's frame with
confidences, and dense descriptors with confidences. A shared ViT encoder
runs on both views in one batch; the CroCo interleaved two-stream decoder
(block i of each stream cross-attends to the other stream's block i-1
output); a DPT pointmap head and a descriptor head per view.

Parameters stay float32. With ``ModelConfig.dtype == "bfloat16"`` (the
``large`` preset) the forward runs under bfloat16 autocast, as the JAX
package computes in bfloat16 over float32 parameters.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import ModelConfig
from ..utils.checkpoint import flatten
from ..utils.device import resolve_device
from ..ops.rope import rope_2d_freqs
from .heads import DownstreamHead, postprocess_pointmap
from .vit import DecoderBlock, EncoderBlock, PatchEmbed, patch_positions

__all__ = ("TwoViewNet", "Mast3rModel", "PairPrediction")

_OUT_KEYS = ("pts1", "conf1", "pts2", "conf2", "desc1", "desc2",
             "desc_conf1", "desc_conf2")


def _dpt_hooks(depth: int) -> Tuple[int, int]:
    """The two mid-decoder DPT hooks (states[i] = block i's output)."""
    return (max(1, depth // 2), max(1, (3 * depth) // 4))


class TwoViewNet(nn.Module):
    """One pair direction: view1-frame pointmaps for both images plus
    descriptors. Attribute names give the public checkpoint key layout."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.enc_dim, cfg.patch_size)
        self.enc_blocks = nn.ModuleList(
            [EncoderBlock(cfg.enc_dim, cfg.enc_heads, cfg.mlp_ratio)
             for _ in range(cfg.enc_depth)])
        self.enc_norm = nn.LayerNorm(cfg.enc_dim, eps=1e-5)
        self.decoder_embed = nn.Linear(cfg.enc_dim, cfg.dec_dim)
        self.dec_blocks = nn.ModuleList(
            [DecoderBlock(cfg.dec_dim, cfg.dec_heads, cfg.mlp_ratio)
             for _ in range(cfg.dec_depth)])
        self.dec_blocks2 = nn.ModuleList(
            [DecoderBlock(cfg.dec_dim, cfg.dec_heads, cfg.mlp_ratio)
             for _ in range(cfg.dec_depth)])
        self.dec_norm = nn.LayerNorm(cfg.dec_dim, eps=1e-5)
        self.downstream_head1 = DownstreamHead(cfg)
        self.downstream_head2 = DownstreamHead(cfg)
        # croco's masked-pretraining token: in the checkpoint, unused here
        self.mask_token = nn.Parameter(torch.zeros(1, 1, cfg.dec_dim))

    def encode(self, img: torch.Tensor, rope) -> torch.Tensor:
        """img (B, H, W, 3) -> (B, T, enc_dim)."""
        x = self.patch_embed(img)
        for blk in self.enc_blocks:
            x = blk(x, rope)
        return self.enc_norm(x)

    def decode(self, f1, f2, rope):
        """Interleaved decoder: both encoder streams through ONE
        decoder_embed, blocks in lockstep reading the previous pair, one
        shared final norm. states{v}[i] is block i-1's output."""
        x1, x2 = self.decoder_embed(f1), self.decoder_embed(f2)
        s1, s2 = [x1], [x2]
        for b1, b2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = b1(x1, x2, rope, rope), b2(x2, x1, rope, rope)
            s1.append(x1)
            s2.append(x2)
        s1[-1] = self.dec_norm(s1[-1])
        s2[-1] = self.dec_norm(s2[-1])
        return s1, s2

    def forward(self, img1: torch.Tensor, img2: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """img1, img2 (B, H, W, 3) in [-1, 1]. Returns float32
        pts1/pts2 (B,H,W,3), conf1/conf2 (B,H,W), desc1/desc2 (B,H,W,D),
        desc_conf1/desc_conf2 (B,H,W)."""
        cfg = self.cfg
        b, h, w, _ = img1.shape
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        pos = patch_positions(hp, wp, img1.device)[None]
        rope_enc = rope_2d_freqs(pos, cfg.enc_dim // cfg.enc_heads,
                                 cfg.rope_base)
        rope_dec = rope_2d_freqs(pos, cfg.dec_dim // cfg.dec_heads,
                                 cfg.rope_base)
        feats = self.encode(torch.cat([img1, img2], dim=0), rope_enc)
        f1, f2 = feats[:b], feats[b:]
        s1, s2 = self.decode(f1, f2, rope_dec)
        k1, k2 = _dpt_hooks(cfg.dec_depth)
        outs = {}
        for view, f, states, head in (("1", f1, s1, self.downstream_head1),
                                      ("2", f2, s2, self.downstream_head2)):
            raw = head.dpt([f, states[k1], states[k2], states[-1]],
                           hp, wp, h, w)
            pts, conf = postprocess_pointmap(raw, cfg.pointmap_mode)
            desc, desc_conf = head.head_local_features(f, states[-1], hp, wp)
            outs[f"pts{view}"] = pts
            outs[f"conf{view}"] = conf
            outs[f"desc{view}"] = desc
            outs[f"desc_conf{view}"] = desc_conf
        return outs


@dataclass
class PairPrediction:
    """One inference direction (i -> j): points of both images in image i's
    frame, on the model's device."""

    idx1: int
    idx2: int
    pts1: torch.Tensor       # (H, W, 3)
    conf1: torch.Tensor      # (H, W)
    pts2: torch.Tensor       # (H, W, 3) image idx2's points, frame idx1
    conf2: torch.Tensor      # (H, W)
    desc1: torch.Tensor      # (H, W, D)
    desc2: torch.Tensor
    desc_conf1: torch.Tensor
    desc_conf2: torch.Tensor


def _init_weights_(net: nn.Module, gen: torch.Generator):
    """Random init from ``gen``: weights N(0, 1/fan_in) (the JAX package's
    lecun-normal scale), biases 0, LayerNorm 1/0; the weights dead at
    inference (the mask token, refinenet4's resConfUnit1) 0, as the JAX
    package's format carries neither and a loaded model holds zeros."""
    for mod in net.modules():
        if isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)
        elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            if isinstance(mod, nn.ConvTranspose2d):
                fan_in = w.shape[0]
            else:
                fan_in = int(np.prod(w.shape[1:]))
            with torch.no_grad():
                w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            if mod.bias is not None:
                nn.init.zeros_(mod.bias)
    nn.init.zeros_(net.mask_token)
    for head in (net.downstream_head1, net.downstream_head2):
        for w in head.dpt.scratch.refinenet4.resConfUnit1.parameters():
            nn.init.zeros_(w)


class Mast3rModel:
    """User-facing model wrapper: holds the config and the network on one
    device and runs batched pair inference."""

    def __init__(self, cfg: ModelConfig, net: TwoViewNet,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()

    @classmethod
    def init_random(cls, cfg: Optional[ModelConfig] = None, seed: int = 0,
                    device="cuda") -> "Mast3rModel":
        cfg = cfg or ModelConfig.tiny()
        dev = resolve_device(device)
        with torch.device("meta"):
            net = TwoViewNet(cfg)
        net = net.to_empty(device=dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        _init_weights_(net, gen)
        return cls(cfg, net, dev)

    @classmethod
    def from_pretrained(cls, path: str, cfg: Optional[ModelConfig] = None,
                        device="cuda") -> "Mast3rModel":
        """Load a checkpoint written by `save_pretrained` of either package
        onto ``device`` (the card unless "cpu"). The geometry is read from
        the file's ``__config__`` entry unless ``cfg`` is given. A weight
        the network needs and the file lacks raises KeyError."""
        # io imports the alignment and splat packages, which import this
        from ..io.from_jax import mast3r_state_dict_from_jax
        dev = resolve_device(device)
        with np.load(path, allow_pickle=False) as data:
            cfg_json = bytes(data["__config__"].tolist()).decode()
            flat = {k: data[k] for k in data.files
                    if not k.startswith("__")}
        saved = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in json.loads(cfg_json).items()}
        cfg = cfg or ModelConfig(**saved)
        tree: Dict = {}
        for key, arr in flat.items():
            *parents, leaf = key.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = arr
        with torch.device("meta"):
            net = TwoViewNet(cfg)
        net = net.to_empty(device=dev)
        sd = mast3r_state_dict_from_jax(tree)
        missing = sorted(set(net.state_dict()) - set(sd))
        if missing:
            raise KeyError(f"checkpoint {path!r} missing weights {missing}")
        net.load_state_dict(sd, strict=True)
        return cls(cfg, net, dev)

    def save_pretrained(self, path: str):
        """Write the weights in the JAX package's format: one ``.npz`` of
        the flax parameter tree under "/"-joined keys, plus a
        ``__config__`` uint8 JSON of the `ModelConfig`. ``np.savez`` on the
        path appends ".npz" when it is missing, as the JAX package's does."""
        from ..io.torch_convert import convert_state_dict
        sd = {k: v.detach().cpu().numpy()
              for k, v in self.state_dict().items()}
        params, unmapped = convert_state_dict(
            sd, self.cfg.enc_depth, self.cfg.dec_depth, self.cfg.patch_size,
            self.cfg.desc_dim)
        if unmapped:
            raise KeyError(f"state dict keys with no flax slot: {unmapped}")
        cfg_json = json.dumps(self.cfg.__dict__)
        np.savez(str(path), __config__=np.frombuffer(cfg_json.encode(),
                                                     dtype=np.uint8),
                 **flatten(params))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def load_state_dict(self, sd: Dict[str, torch.Tensor]):
        self.net.load_state_dict(sd, strict=True)
        return self

    @torch.inference_mode()
    def infer_pair_batch(self, img1: torch.Tensor, img2: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
        """img1/img2 (B, H, W, 3) [-1, 1] float32 on the model's device."""
        bf16 = self.cfg.dtype == "bfloat16"
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            return self.net(img1, img2)

    def infer_pairs(self, images: Sequence, pair_indices:
                    Sequence[Tuple[int, int]], batch_size: int = 8,
                    sharding=None) -> List[PairPrediction]:
        """Pairwise inference over a pair graph. images: (3, H, W) arrays
        of one resolution. Pairs go ``batch_size`` at a time into one forward;
        the last batch is padded to full size, as in the JAX package.

        ``sharding`` (`parallel.pair_sharding(mesh)`): pair-parallel
        inference. Each batch keeps its full size, which the sharding's
        axis size must divide; rank r of the axis runs the r-th contiguous
        share of every padded batch and the outputs are all-gathered over
        the axis, so every rank returns every prediction. Every rank of the
        mesh calls this with the same pairs."""
        if not pair_indices:
            return []
        imgs = torch.stack([torch.as_tensor(np.asarray(im, np.float32))
                            for im in images]).to(self.device)
        imgs = imgs.permute(0, 2, 3, 1).contiguous()        # (N, H, W, 3)
        results: List[PairPrediction] = []
        n = len(pair_indices)
        if sharding is None:
            bs, group, share = min(batch_size, n), None, slice(None)
        else:
            from ..parallel.mesh import axis_group, axis_rank, axis_size
            axis = sharding.spec[0]
            w = axis_size(sharding.mesh, axis)
            if batch_size % w:
                raise ValueError(f"batch_size {batch_size} does not split "
                                 f"over {w} ranks of axis {axis!r}")
            # under a sharding the batch stays divisible by the axis: keep
            # the full batch and let the tail pad
            bs, group = batch_size, axis_group(sharding.mesh, axis)
            r = axis_rank(sharding.mesh, axis)
            share = slice(r * bs // w, (r + 1) * bs // w)
        for start in range(0, n, bs):
            chunk = list(pair_indices[start: start + bs])
            chunk_p = (chunk + [chunk[-1]] * (bs - len(chunk)))[share]
            i_idx = torch.tensor([p[0] for p in chunk_p], device=self.device)
            j_idx = torch.tensor([p[1] for p in chunk_p], device=self.device)
            out = self.infer_pair_batch(imgs[i_idx], imgs[j_idx])
            if group is not None:
                from ..parallel.comm import all_gather_rows
                out = {f: all_gather_rows(out[f], group) for f in _OUT_KEYS}
            for k, (i, j) in enumerate(chunk):
                results.append(PairPrediction(
                    idx1=i, idx2=j, **{f: out[f][k] for f in _OUT_KEYS}))
        return results
