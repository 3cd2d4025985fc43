"""Fast3R (Yang et al., "Fast3R: Towards 3D Reconstruction of 1000+ Images
in One Forward Pass", CVPR 2025, arXiv:2501.13928; facebookresearch/fast3r,
`Fast3R_ViT_Large_512`): DUSt3R's trunk made N-view. All N views of a
scene go through one forward; no pairs, no matching, no global alignment.

  - encoder: CroCo's ViT (`vit.PatchEmbed`, `vit.EncoderBlock`,
    `vit.encode_tokens`, RoPE at base 100) on each view alone, in chunks
    of ``enc_chunk`` views, as MASt3R's encoder runs;
  - fusion: ``decoder_embed`` (enc_dim -> dec_dim), view i's image-index
    embedding added to each of its tokens (`image_index_embedding`), then
    ``dec_depth`` pre-LN blocks over the (1, N P, dec_dim) tokens of all
    views at once, with 2D RoPE on each token's own patch (y, x), and
    ``dec_norm`` on the last block's output. Each fusion attention call is
    `ops.attention.rope_attention`, which over a scene's keys (from
    `ROTATE_ONCE_KEYS` on; 49,152 at 64 views of 512 x 384) rotates q and
    k once: on the card one `rope_rotate` launch and one attention launch
    with no tables;
  - heads: two DPT heads (`heads.DPTHead`, MASt3R's variant), ``head_local``
    (each view's points in its own camera frame) and ``head_global`` (in
    view 0's camera frame), each reading [encoder output, fusion blocks
    depth/2 and 3 depth/4, the normed last] (`mast3r._dpt_hooks`), views in
    chunks of ``heads_chunk``; points by `postprocess_pointmap` ("exp"),
    confidence 1 + exp;
  - cameras (`pointmap_cameras`, on the card): one focal for every view,
    from view 0's global pointmap weighted by its confidence
    (`utils.camera.estimate_focal_from_pointmap`, principal point at the
    centre), and each view's cam2w by a rigid Procrustes of its local
    points onto its global points, weighted by the product of their
    confidences (`utils.camera.rigid_procrustes`), all views in one
    batched solve; depth is the local points' z with the local confidence.
    Fast3R runs OpenCV's PnP-RANSAC per view on the host instead; the
    port has no PnP.

Precision as the port runs MASt3R: the encoder, the fusion and the heads
under bfloat16 autocast over float32 parameters (`Fast3RConfig.dtype`),
the heads' last convolution and the cameras in float32.

Parameter names: the encoder's and fusion's follow the CroCo checkpoint
layout the port's MASt3R uses (`enc_blocks.{i}.attn.qkv`,
`decoder_embed`, `dec_blocks.{i}.mlp.fc1`, `dec_norm`); the heads' are
`DPTHead`'s under ``head_local`` and ``head_global``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..config import Fast3RConfig
from ..ops.attention import rope_attention
from ..ops.rope import rope_2d_freqs
from ..utils.camera import (estimate_focal_from_pointmap, make_intrinsics,
                            rigid_procrustes)
from ..utils.device import resolve_device
from ..utils.profiling import span
from .heads import DPTHead, postprocess_pointmap
from .mast3r import _dpt_hooks
from .vit import Attention, EncoderBlock, PatchEmbed, encode_tokens, \
    patch_positions

__all__ = ("Fast3RNet", "Fast3RModel", "image_index_embedding",
           "pointmap_cameras")

# the fusion blocks' q and k weights at QK_GAIN times the fan-in scale
# (`init_fast3r_weights_`)
QK_GAIN = 2.0


def image_index_embedding(n: int, dim: int, device) -> torch.Tensor:
    """(n, dim) float32: index i's 1D sin-cos embedding (MAE's
    `get_1d_sincos_pos_embed_from_grid`: sin(i w_j) then cos(i w_j), w_j =
    10000 ** (-j / (dim / 2))), computed in float64. View 0 takes index 0,
    view i index i: at inference the published model is assumed to number
    the views in order (it draws sorted indices from a wider range in
    training; the configuration's `assumed`)."""
    half = dim // 2
    omega = 1.0 / 10000.0 ** (torch.arange(half, dtype=torch.float64,
                                           device=device) / half)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] \
        * omega[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], 1).float()


class FusionAttention(Attention):
    """`vit.Attention` over a scene's tokens, the `rope_attention` call
    alone in the span ``fast3r/fuse_attn``."""

    def forward(self, x, rope):
        b, t, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, t, 3, self.heads,
                                      self.head_dim).unbind(2)
        with span("fast3r/fuse_attn"):
            o = rope_attention(q, k, v, rope, rope)
        return self.proj(o.reshape(b, t, -1))


class FusionBlock(EncoderBlock):
    """A pre-LN block of the fusion transformer: `vit.EncoderBlock` with
    `FusionAttention`."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float = 4.0):
        super().__init__(dim, heads, mlp_ratio)
        self.attn = FusionAttention(dim, heads)


class Fast3RNet(nn.Module):
    def __init__(self, cfg: Fast3RConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.enc_dim, cfg.patch_size)
        self.enc_blocks = nn.ModuleList(
            [EncoderBlock(cfg.enc_dim, cfg.enc_heads, cfg.mlp_ratio)
             for _ in range(cfg.enc_depth)])
        self.enc_norm = nn.LayerNorm(cfg.enc_dim, eps=1e-5)
        self.decoder_embed = nn.Linear(cfg.enc_dim, cfg.dec_dim)
        self.dec_blocks = nn.ModuleList(
            [FusionBlock(cfg.dec_dim, cfg.dec_heads, cfg.mlp_ratio)
             for _ in range(cfg.dec_depth)])
        self.dec_norm = nn.LayerNorm(cfg.dec_dim, eps=1e-5)
        dims = (cfg.enc_dim,) + (cfg.dec_dim,) * 3
        self.head_local, self.head_global = (
            DPTHead(dims, 4, cfg.dpt_feature_dim, cfg.dpt_layer_dims,
                    cfg.dpt_last_dim) for _ in range(2))

    def fuse(self, feats: torch.Tensor, pos: torch.Tensor):
        """feats (N, P, enc_dim) encoder tokens, pos (P, 2) their patches ->
        the DPT hooks' fusion states, each (N, P, dec_dim): blocks depth/2
        and 3 depth/4, and the normed last."""
        cfg = self.cfg
        n, p, _ = feats.shape
        # the image-index embedding added after `decoder_embed` (assumed:
        # the configuration's `assumed`)
        x = self.decoder_embed(feats) + image_index_embedding(
            n, cfg.dec_dim, feats.device)[:, None]
        x = x.reshape(1, n * p, -1)
        rope = rope_2d_freqs(pos.repeat(n, 1)[None],
                             cfg.dec_dim // cfg.dec_heads, cfg.rope_base)
        k1, k2 = _dpt_hooks(cfg.dec_depth)
        hooks = {}
        for i, blk in enumerate(self.dec_blocks, 1):
            x = blk(x, rope)
            if i in (k1, k2):
                hooks[i] = x
        x = self.dec_norm(x)
        return [t.reshape(n, p, -1) for t in (hooks[k1], hooks[k2], x)]

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        """img (N, H, W, 3) in [-1, 1], H and W multiples of the patch.
        Returns float32 pts_local, pts_global (N, H, W, 3) and conf_local,
        conf_global (N, H, W). Autocast is the caller's
        (`Fast3RModel.infer`)."""
        cfg = self.cfg
        n, h, w, _ = img.shape
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        pos = patch_positions(hp, wp, img.device)
        rope = rope_2d_freqs(pos[None], cfg.enc_dim // cfg.enc_heads,
                             cfg.rope_base)
        with span("fast3r/encode"):
            feats = torch.cat([
                encode_tokens(self.patch_embed, self.enc_blocks,
                              self.enc_norm, img[c:c + cfg.enc_chunk], rope)
                for c in range(0, n, cfg.enc_chunk)])
        with span("fast3r/fuse"):
            states = [feats] + self.fuse(feats, pos)
        out = {}
        with span("fast3r/heads"):
            for name, head in (("local", self.head_local),
                               ("global", self.head_global)):
                pts, conf = zip(*(
                    postprocess_pointmap(head(
                        [s[c:c + cfg.heads_chunk] for s in states],
                        hp, wp, h, w), cfg.pointmap_mode)
                    for c in range(0, n, cfg.heads_chunk)))
                out[f"pts_{name}"] = torch.cat(pts)
                out[f"conf_{name}"] = torch.cat(conf)
        return out


def pointmap_cameras(pts_local: torch.Tensor, conf_local: torch.Tensor,
                     pts_global: torch.Tensor, conf_global: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cameras of N views from their pointmaps, (N, H, W, 3) and (N, H,
    W), float32 -> (cam2w (N, 4, 4), K (N, 3, 3)): one focal from view 0's
    global pointmap (its camera frame) weighted by its global confidence,
    the principal point at (W / 2, H / 2), shared by every view; each
    view's cam2w the rigid motion that takes its local points onto its
    global points, weighted by the product of their confidences."""
    n, h, w, _ = pts_local.shape
    dev = pts_local.device
    pp = torch.tensor([w / 2.0, h / 2.0], device=dev)
    focal = estimate_focal_from_pointmap(pts_global[0], pp, conf_global[0])
    K = make_intrinsics(focal.expand(n), pp.expand(n, 2))
    rot, trans = rigid_procrustes(pts_local.reshape(n, -1, 3),
                                  pts_global.reshape(n, -1, 3),
                                  (conf_local * conf_global).reshape(n, -1))
    cam2w = torch.eye(4, device=dev).repeat(n, 1, 1)
    cam2w[:, :3, :3] = rot
    cam2w[:, :3, 3] = trans
    return cam2w, K


def init_fast3r_weights_(net: Fast3RNet, gen: torch.Generator):
    """Random init from ``gen``, the rule the benchmark's configuration
    states: weights N(0, 1/fan_in) (a transposed convolution's fan-in its
    first axis), biases 0, LayerNorm 1/0, refinenet4's first residual unit
    (never read) 0; the fusion blocks' q and k rows of ``qkv`` at
    `QK_GAIN` times that scale. Fast3R has no qk-norm: at 1 a random
    network's fusion logits have a standard deviation near 1 and attention
    over a scene's 49k tokens is near uniform, so that a fusion attending
    within each view alone would differ from it by little; at 2 the
    deviation is near 4."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan = (w.shape[0] if isinstance(mod, nn.ConvTranspose2d)
                       else int(np.prod(w.shape[1:])))
                w.normal_(0.0, 1.0 / math.sqrt(fan), generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()
        for blk in net.dec_blocks:
            blk.attn.qkv.weight[:2 * net.cfg.dec_dim].mul_(QK_GAIN)
        for head in (net.head_local, net.head_global):
            for p in head.scratch.refinenet4.resConfUnit1.parameters():
                p.zero_()


class Fast3RModel:
    """User-facing Fast3R wrapper: the config and the network on one
    device; `infer` runs one forward over all views of a scene and
    `infer_scene` adds the cameras."""

    def __init__(self, cfg: Fast3RConfig, net: Fast3RNet, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()

    @classmethod
    def init_random(cls, cfg: Optional[Fast3RConfig] = None, seed: int = 0,
                    device="cuda") -> "Fast3RModel":
        """Random weights from ``seed`` (`init_fast3r_weights_`) on
        ``device`` (the card unless "cpu")."""
        cfg = cfg or Fast3RConfig.tiny()
        dev = resolve_device(device)
        with torch.device("meta"):
            net = Fast3RNet(cfg)
        net = net.to_empty(device=dev)
        init_fast3r_weights_(net,
                             torch.Generator(device=dev).manual_seed(seed))
        return cls(cfg, net, dev)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def load_state_dict(self, sd: Dict[str, torch.Tensor]):
        self.net.load_state_dict(sd, strict=True)
        return self

    @torch.inference_mode()
    def infer(self, images: Sequence) -> Dict[str, torch.Tensor]:
        """images: N (3, H, W) arrays in [-1, 1] of one size (`load_images`
        in its default mode) -> `Fast3RNet.forward`'s outputs on the
        model's device."""
        imgs = torch.stack([torch.as_tensor(np.asarray(im, np.float32))
                            for im in images]).to(self.device)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.cfg.dtype == "bfloat16"):
            return self.net(imgs.permute(0, 2, 3, 1).contiguous())

    @torch.inference_mode()
    def infer_scene(self, images: Sequence):
        """One forward and the cameras -> (cam2w (N, 4, 4), K (N, 3, 3),
        depth (N, H, W), its confidence (N, H, W)), float32 on the model's
        device."""
        out = self.infer(images)
        with span("fast3r/cameras"):
            cam2w, K = pointmap_cameras(out["pts_local"], out["conf_local"],
                                        out["pts_global"],
                                        out["conf_global"])
        return cam2w, K, out["pts_local"][..., 2], out["conf_local"]
