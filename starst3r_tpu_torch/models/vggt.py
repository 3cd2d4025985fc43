"""VGGT, the Visual Geometry Grounded Transformer (Wang et al., CVPR 2025,
arXiv:2503.11651; facebookresearch/vggt), without its track head: all S
views of a scene in one forward, returning each view's camera (a pose
encoding), depth map and world-point map with their confidences. No
pairs, no matching, no global alignment.

  - encoder (`DinoV2`): DINOv2 ViT-L/14 with 4 register tokens on ImageNet-
    normalised images; its learned 37 x 37 position table resampled to the
    patch grid (bicubic, antialiased); 24 pre-LN blocks (LayerNorm eps
    1e-6, LayerScale, no RoPE); the final LayerNorm's patch tokens.
  - aggregator (`Aggregator`): per view [camera token, 4 register tokens,
    patch tokens] (view 0 takes index 0 of the (2, ...) token tables, every
    other view index 1); ``depth`` iterations of a frame block over (S, P,
    C) and a global block over (1, S x P, C), each with qk-norm, 2D RoPE
    at frequency 100 (patch positions + 1, special tokens 0) and
    LayerScale; iteration i's output is [frame out, global out], 2 C wide.
  - camera head (`CameraHead`): the last iteration's camera tokens, refined
    ``camera_iters`` times through adaLN modulation by the previous
    encoding and 4 blocks over the S camera tokens; the encoding is
    absT_quaR_FoV (t, quaternion x y z w, FoV h w), FoV through a ReLU.
  - DPT heads (`heads.DPTHead` with ``vggt=True``): depth (exp, confidence
    1 + exp) and world points (sign(x) (e^|x| - 1), confidence 1 + exp)
    from iterations ``head_layers``, views in chunks of ``frames_chunk``.

Precision as VGGT's `forward` runs it: the encoder and aggregator under
bfloat16 autocast over float32 parameters (`VGGTConfig.dtype`), the camera
and DPT heads in float32 with autocast off. Their attention on the card
is `ops.attention.fused_sdpa` (the flash kernel; the global blocks attend
over 33,312 tokens at 32 views of 518 x 392); the camera head's blocks
attend over S float32 tokens and take `sdpa`.

Parameter names follow the published checkpoint's (`aggregator.
frame_blocks.{i}.attn.q_norm`, `camera_head.poseLN_modulation.1`, ...),
except the DPT heads', which are `heads.DPTHead`'s (`act_postprocess`,
`head.{0,2,4}` for VGGT's `projects` + `resize_layers`, `output_conv1`,
`output_conv2`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import VGGTConfig
from ..ops.attention import fused_sdpa, sdpa
from ..ops.rope import apply_rope_2d, rope_2d_freqs
from ..utils.device import resolve_device
from ..utils.profiling import NULL_SPAN, span
from .heads import DPTHead
from .vit import Mlp, PatchEmbed, patch_positions

__all__ = ("VGGTNet", "VGGTModel", "activate_pose",
           "pose_encoding_to_cameras")

# ImageNet mean and std, applied inside the network (vggt/models/
# aggregator.py `_RESNET_MEAN`, `_RESNET_STD`)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

OUT_KEYS = ("pose_enc", "depth", "depth_conf", "world_points",
            "world_points_conf")


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class VGGTAttention(nn.Module):
    """Self-attention with a biased qkv, optional qk-norm (LayerNorm over
    the head dim, eps 1e-5) and 2D RoPE after it. ``fused``: the
    attention call is `fused_sdpa` (q, k, v in the value's dtype, which
    autocast makes bfloat16), else `sdpa`; ``span_name`` names that call
    alone in a trace."""

    def __init__(self, dim: int, heads: int, qk_norm: bool, fused: bool,
                 span_name: Optional[str] = None):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        self.fused, self.span_name = fused, span_name
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if qk_norm:
            self.q_norm = nn.LayerNorm(self.head_dim, eps=1e-5)
            self.k_norm = nn.LayerNorm(self.head_dim, eps=1e-5)

    def forward(self, x, rope=None):
        b, t, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, t, 3, self.heads,
                                      self.head_dim).unbind(2)
        if hasattr(self, "q_norm"):
            q, k = self.q_norm(q), self.k_norm(k)
        if rope is not None:
            q, k = apply_rope_2d(q, k, *rope)
        if self.fused:
            q, k = q.to(v.dtype), k.to(v.dtype)
            with span(self.span_name) if self.span_name else NULL_SPAN:
                o = fused_sdpa(q, k, v)
        else:
            o = sdpa(q, k, v)
        return self.proj(o.reshape(b, t, -1))


class VGGTBlock(nn.Module):
    """Pre-LN block with LayerScale on both branches (vggt/layers/
    block.py): x + ls1(attn(norm1(x))), then + ls2(mlp(norm2(x)))."""

    def __init__(self, dim: int, heads: int, mlp_ratio: float, eps: float,
                 qk_norm: bool, fused: bool = True,
                 span_name: Optional[str] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = VGGTAttention(dim, heads, qk_norm, fused, span_name)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x, rope=None):
        x = x + self.ls1(self.attn(self.norm1(x), rope))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoV2(nn.Module):
    """DINOv2 ViT-L/14 with register tokens (`aggregator.patch_embed` in
    the checkpoint): images (S, 3, H, W), already normalised -> the final
    LayerNorm's patch tokens (S, hp wp, C)."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        c, p = cfg.dim, cfg.patch_size
        m = cfg.img_size // p
        self.patch_size = p
        self.patch_embed = PatchEmbed(c, p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + m * m, c))
        self.register_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_register_tokens, c))
        # DINOv2's masked-pretraining token: in the checkpoint, unused here
        self.mask_token = nn.Parameter(torch.zeros(1, c))
        self.blocks = nn.ModuleList(
            [VGGTBlock(c, cfg.heads, cfg.mlp_ratio, 1e-6, qk_norm=False)
             for _ in range(cfg.enc_depth)])
        self.norm = nn.LayerNorm(c, eps=1e-6)

    def position_table(self, hp: int, wp: int) -> torch.Tensor:
        """(1, 1 + hp wp, C): the cls position and the patch table
        resampled from its square grid to (hp, wp), rows to rows, by
        bicubic interpolation with antialiasing (DINOv2's
        `interpolate_pos_encoding` with VGGT's interpolate_offset 0)."""
        pe = self.pos_embed.float()
        cls, grid = pe[:, :1], pe[:, 1:]
        m = math.isqrt(grid.shape[1])
        if (hp, wp) != (m, m):
            g = grid.reshape(1, m, m, -1).permute(0, 3, 1, 2)
            g = F.interpolate(g, size=(hp, wp), mode="bicubic",
                              antialias=True)
            grid = g.permute(0, 2, 3, 1).reshape(1, hp * wp, -1)
        return torch.cat([cls, grid], 1)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        s, _, h, w = img.shape
        hp, wp = h // self.patch_size, w // self.patch_size
        # the tokens in float32 from here, as torch.cat promotes them in
        # DINOv2's `prepare_tokens_with_masks` (the convolution's bfloat16
        # rounding stays)
        x = self.patch_embed(img.permute(0, 2, 3, 1)).float()
        x = torch.cat([self.cls_token.expand(s, -1, -1), x], 1)
        x = x + self.position_table(hp, wp)
        x = torch.cat([x[:, :1], self.register_tokens.expand(s, -1, -1),
                       x[:, 1:]], 1)
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)[:, 1 + self.register_tokens.shape[1]:]


class Aggregator(nn.Module):
    """The alternating-attention trunk (vggt/models/aggregator.py)."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        c = cfg.dim
        self.cfg = cfg
        self.patch_embed = DinoV2(cfg)
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, c))
        self.register_token = nn.Parameter(
            torch.zeros(1, 2, cfg.num_register_tokens, c))
        self.patch_start_idx = 1 + cfg.num_register_tokens
        self.frame_blocks = nn.ModuleList(
            [VGGTBlock(c, cfg.heads, cfg.mlp_ratio, 1e-5, qk_norm=True)
             for _ in range(cfg.depth)])
        self.global_blocks = nn.ModuleList(
            [VGGTBlock(c, cfg.heads, cfg.mlp_ratio, 1e-5, qk_norm=True,
                       span_name="vggt/global_attn")
             for _ in range(cfg.depth)])
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN)
                             .view(1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD)
                             .view(1, 3, 1, 1), persistent=False)

    def reset_buffers(self):
        """The ImageNet mean and std (`to_empty` leaves them unset)."""
        self.mean.copy_(torch.tensor(IMAGENET_MEAN).view(1, 3, 1, 1))
        self.std.copy_(torch.tensor(IMAGENET_STD).view(1, 3, 1, 1))

    def special_tokens(self, s: int) -> torch.Tensor:
        """(S, 1 + R, C): view 0's camera and register tokens from index 0
        of the tables, every other view's from index 1."""
        tok = torch.cat([self.camera_token, self.register_token], 2)[0]
        return torch.cat([tok[:1], tok[1:].expand(s - 1, -1, -1)], 0)

    def positions(self, hp: int, wp: int, device) -> torch.Tensor:
        """(P, 2) RoPE positions: the special tokens at 0, patch (y, x) at
        (y + 1, x + 1)."""
        pos = patch_positions(hp, wp, device) + 1
        return torch.cat([torch.zeros(self.patch_start_idx, 2,
                                      dtype=pos.dtype, device=device), pos])

    def global_block(self, blk: VGGTBlock, x: torch.Tensor, rope_all):
        """One global block over all S x P tokens of the scene."""
        s, p, c = x.shape
        return blk(x.reshape(1, s * p, c), rope_all).reshape(s, p, c)

    def forward(self, images: torch.Tensor) -> Dict[int, torch.Tensor]:
        """images (S, 3, H, W) in [0, 1] -> {iteration i in
        ``keep``: (S, P, 2 C)}, ``keep`` the heads' iterations."""
        cfg = self.cfg
        s, _, h, w = images.shape
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        with span("vggt/encode"):
            patches = self.patch_embed((images - self.mean) / self.std)
        x = torch.cat([self.special_tokens(s), patches], 1)
        hd = cfg.dim // cfg.heads
        cos, sin = rope_2d_freqs(self.positions(hp, wp, images.device), hd,
                                 cfg.rope_base)
        rope, rope_all = (cos, sin), (cos.repeat(s, 1), sin.repeat(s, 1))
        keep = set(cfg.head_layers) | {cfg.depth - 1}
        out = {}
        for i, (fb, gb) in enumerate(zip(self.frame_blocks,
                                         self.global_blocks)):
            with span("vggt/frame"):
                x = fb(x, rope)
            frame = x
            with span("vggt/global"):
                x = self.global_block(gb, x, rope_all)
            if i in keep:
                out[i] = torch.cat([frame, x], -1)
        return out


def activate_pose(enc: torch.Tensor) -> torch.Tensor:
    """absT_quaR_FoV's activations: translation and quaternion linear,
    the two FoVs through a ReLU."""
    return torch.cat([enc[..., :7], F.relu(enc[..., 7:])], -1)


class CameraHead(nn.Module):
    """The camera head (vggt/heads/camera_head.py), over the last
    iteration's camera tokens (S, 2 C)."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        d = 2 * cfg.dim
        self.iters = cfg.camera_iters
        self.trunk = nn.ModuleList(
            [VGGTBlock(d, cfg.camera_heads, 4.0, 1e-5, qk_norm=False,
                       fused=False) for _ in range(cfg.camera_depth)])
        self.token_norm = nn.LayerNorm(d, eps=1e-5)
        self.trunk_norm = nn.LayerNorm(d, eps=1e-5)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, 9))
        self.embed_pose = nn.Linear(9, d)
        self.poseLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(d, 3 * d))
        self.adaln_norm = nn.LayerNorm(d, eps=1e-6, elementwise_affine=False)
        self.pose_branch = Mlp(d, d // 2, 9)

    def forward(self, cam_tokens: torch.Tensor) -> List[torch.Tensor]:
        """cam_tokens (S, 2 C) -> each iteration's activated encoding
        (S, 9). Every iteration modulates the same normed tokens; the
        previous encoding enters detached, as published."""
        tokens = self.token_norm(cam_tokens)[None]          # (1, S, 2C)
        enc, outs = None, []
        for _ in range(self.iters):
            src = (self.empty_pose_tokens.expand(1, tokens.shape[1], -1)
                   if enc is None else enc.detach())
            shift, scale, gate = self.poseLN_modulation(
                self.embed_pose(src)).chunk(3, -1)
            x = gate * (self.adaln_norm(tokens) * (1 + scale) + shift) \
                + tokens
            for blk in self.trunk:
                x = blk(x)
            delta = self.pose_branch(self.trunk_norm(x))
            enc = delta if enc is None else enc + delta
            outs.append(activate_pose(enc)[0])
        return outs


class DenseHead(nn.Module):
    """A DPT head over the kept iterations' patch tokens: LayerNorm
    (2 C, eps 1e-5), then `DPTHead` in VGGT's variant."""

    def __init__(self, cfg: VGGTConfig, out_ch: int):
        super().__init__()
        d = 2 * cfg.dim
        self.norm = nn.LayerNorm(d, eps=1e-5)
        self.dpt = DPTHead((d,) * 4, out_ch, cfg.dpt_feature_dim,
                           cfg.dpt_layer_dims, cfg.dpt_last_dim, vggt=True)

    def forward(self, states: Sequence[torch.Tensor], hp: int, wp: int,
                h: int, w: int) -> torch.Tensor:
        """states: 4 x (B, hp wp, 2 C) patch tokens -> (B, H, W, out)."""
        return self.dpt([self.norm(t) for t in states], hp, wp, h, w)


class VGGTNet(nn.Module):
    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        self.aggregator = Aggregator(cfg)
        self.camera_head = CameraHead(cfg)
        self.depth_head = DenseHead(cfg, 2)
        self.point_head = DenseHead(cfg, 4)

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """images (S, 3, H, W) in [0, 1], H and W multiples of the patch.
        Returns float32 pose_enc (S, 9) and pose_enc_list (each camera
        iteration's), depth (S, H, W, 1), depth_conf (S, H, W),
        world_points (S, H, W, 3), world_points_conf (S, H, W)."""
        cfg = self.cfg
        s, _, h, w = images.shape
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        with torch.autocast(images.device.type, dtype=torch.bfloat16,
                            enabled=cfg.dtype == "bfloat16"):
            tokens = self.aggregator(images)
        tokens = {i: t.float() for i, t in tokens.items()}
        with torch.autocast(images.device.type, enabled=False):
            with span("vggt/camera"):
                encs = self.camera_head(tokens[cfg.depth - 1][:, 0])
            with span("vggt/heads"):
                start = self.aggregator.patch_start_idx
                raw_d, raw_p = [], []
                for c0 in range(0, s, cfg.frames_chunk):
                    states = [tokens[i][c0:c0 + cfg.frames_chunk, start:]
                              for i in cfg.head_layers]
                    raw_d.append(self.depth_head(states, hp, wp, h, w))
                    raw_p.append(self.point_head(states, hp, wp, h, w))
                raw_d, raw_p = torch.cat(raw_d), torch.cat(raw_p)
        xyz = raw_p[..., :3]
        return {"pose_enc": encs[-1], "pose_enc_list": encs,
                "depth": torch.exp(raw_d[..., :1]),
                "depth_conf": 1.0 + torch.exp(raw_d[..., 1]),
                "world_points": torch.sign(xyz) * torch.expm1(xyz.abs()),
                "world_points_conf": 1.0 + torch.exp(raw_p[..., 3])}


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) as (x, y, z, w), any norm -> rotations
    (..., 3, 3) (vggt/utils/rotation.py `quat_to_mat`)."""
    i, j, k, r = q.unbind(-1)
    two_s = 2.0 / (q * q).sum(-1)
    o = torch.stack((
        1 - two_s * (j * j + k * k), two_s * (i * j - k * r),
        two_s * (i * k + j * r),
        two_s * (i * j + k * r), 1 - two_s * (i * i + k * k),
        two_s * (j * k - i * r),
        two_s * (i * k - j * r), two_s * (j * k + i * r),
        1 - two_s * (i * i + j * j)), -1)
    return o.reshape(q.shape[:-1] + (3, 3))


def pose_encoding_to_cameras(enc: torch.Tensor, h: int, w: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """absT_quaR_FoV encodings (S, 9) of H x W views -> (cam2w (S, 4, 4),
    K (S, 3, 3)). The encoding is an OpenCV camera-from-world [R | t]; fy
    = (H / 2) / tan(fov_h / 2), fx = (W / 2) / tan(fov_w / 2), the
    principal point at the image centre (vggt/utils/pose_enc.py
    `pose_encoding_to_extri_intri`)."""
    from ..utils.se3 import se3_inverse
    enc = enc.float()
    w2c = torch.zeros(enc.shape[0], 4, 4, device=enc.device)
    w2c[:, :3, :3] = quat_to_mat(enc[:, 3:7])
    w2c[:, :3, 3] = enc[:, :3]
    w2c[:, 3, 3] = 1.0
    K = torch.zeros(enc.shape[0], 3, 3, device=enc.device)
    K[:, 0, 0] = (w / 2.0) / torch.tan(enc[:, 8] / 2.0)
    K[:, 1, 1] = (h / 2.0) / torch.tan(enc[:, 7] / 2.0)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2.0, h / 2.0, 1.0
    return se3_inverse(w2c), K


def init_vggt_weights_(net: VGGTNet, gen: torch.Generator):
    """Random init from ``gen``, the rule the benchmark's configuration
    states: every weight N(0, 1/fan_in), biases 0, LayerNorm 1/0,
    LayerScale 1 (the published 0.01 would make a random network nearly
    the identity); the camera, register and cls tokens, the position
    table and the empty pose tokens N(0, 1), a patch token's scale; the
    mask token 0. The qk-norm's weight `QK_GAIN`: at 1 a random network's
    attention logits have a standard deviation of 1, nearly uniform
    weights over a global block's 33k tokens, so that the global blocks
    would average every view alike; at 2 the logits' deviation is 4, as
    peaked as trained attention. The pose branch's last layer at
    0.1/sqrt(fan_in) with
    a bias (0, 0, 0, 0, 0, 0, 1, 0.25, 0.25): its four refinements then
    sum to FoVs near 1 rad, where a random one would put half of them
    through the ReLU at 0 (an infinite focal)."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.endswith("mask_token"):
                p.zero_()
            elif leaf == "gamma":
                p.fill_(1.0)
            elif p.dim() == 1 and "norm" in name.rsplit(".", 2)[-2]:
                gain = QK_GAIN if name.endswith(("q_norm.weight",
                                                 "k_norm.weight")) else 1.0
                p.fill_(gain if leaf == "weight" else 0.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "weight":
                fan = (p.shape[0] if ".act_postprocess.0.1." in name
                       or ".act_postprocess.1.1." in name
                       else int(np.prod(p.shape[1:])))
                p.normal_(0.0, 1.0 / math.sqrt(fan), generator=gen)
            else:                            # tokens and the position table
                p.normal_(0.0, 1.0, generator=gen)
        last = net.camera_head.pose_branch.fc2
        last.weight.mul_(0.1)
        last.bias.copy_(torch.tensor(POSE_BIAS))


POSE_BIAS = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.25, 0.25)
QK_GAIN = 2.0


class VGGTModel:
    """User-facing VGGT wrapper: the config and the network on one device;
    `infer` runs one forward over all views of a scene."""

    def __init__(self, cfg: VGGTConfig, net: VGGTNet, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()

    @classmethod
    def init_random(cls, cfg: Optional[VGGTConfig] = None, seed: int = 0,
                    device="cuda") -> "VGGTModel":
        """Random weights from ``seed`` (`init_vggt_weights_`) on
        ``device`` (the card unless "cpu")."""
        cfg = cfg or VGGTConfig.tiny()
        dev = resolve_device(device)
        with torch.device("meta"):
            net = VGGTNet(cfg)
        net = net.to_empty(device=dev)
        net.aggregator.reset_buffers()
        init_vggt_weights_(net, torch.Generator(device=dev).manual_seed(seed))
        return cls(cfg, net, dev)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.net.state_dict()

    def load_state_dict(self, sd: Dict[str, torch.Tensor]):
        self.net.load_state_dict(sd, strict=True)
        return self

    @torch.inference_mode()
    def infer(self, images: Sequence) -> Dict[str, torch.Tensor]:
        """images: S (3, H, W) arrays in [0, 1] of one size (`load_images`
        with ``mode="crop"``) -> `VGGTNet.forward`'s outputs on the
        model's device."""
        imgs = torch.stack([torch.as_tensor(np.asarray(im, np.float32))
                            for im in images]).to(self.device)
        return self.net(imgs)

    @torch.inference_mode()
    def infer_scene(self, images: Sequence):
        """One forward and the cameras of its pose encodings -> (cam2w
        (S, 4, 4), K (S, 3, 3), depth (S, H, W), its confidence (S, H, W))
        on the model's device."""
        out = self.infer(images)
        h, w = out["depth"].shape[1:3]
        cam2w, K = pose_encoding_to_cameras(out["pose_enc"], h, w)
        return cam2w, K, out["depth"][..., 0], out["depth_conf"]
