"""Prediction heads: DPT pointmap head and MLP local-descriptor head (port
of `starst3r_tpu/models/heads.py`).

Module names follow the public MASt3R checkpoint
(`downstream_head{v}.dpt.act_postprocess.{i}`, `.dpt.scratch.layer{j}_rn`,
`.dpt.scratch.refinenet{j}.resConfUnit{1,2}`, `.dpt.head.{0,2,4}`,
`downstream_head{v}.head_local_features.fc{1,2}`). The non-overlapping
transposed convolutions stay `ConvTranspose2d`, and the descriptor head uses
torch's pixel_shuffle channel order, as the checkpoint does.

Fidelity to the JAX package:
  - bilinear resizes are align_corners=True; where an axis has one input or
    one output sample the JAX interpolation matrix averages, and so does
    `_resize_align_corners` here;
  - pointmap and descriptor confidences are 1 + exp(clip(raw, -10, 10));
  - the last pointmap conv (`head.4`) and the descriptor `fc2` run in
    float32 even when the trunk runs in bfloat16.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ("DPTHead", "DescriptorHead", "DownstreamHead",
           "postprocess_pointmap")


def _interp_matrix_ac(n_in: int, n_out: int, device, dtype) -> torch.Tensor:
    """(n_out, n_in) align_corners=True linear-interpolation matrix; the
    JAX package averages when either side has one sample."""
    if n_in == 1 or n_out == 1:
        return torch.full((n_out, n_in), 1.0 / n_in, device=device,
                          dtype=dtype)
    src = torch.arange(n_out, dtype=torch.float64) * (n_in - 1) / (n_out - 1)
    lo = torch.clamp(torch.floor(src).long(), 0, n_in - 2)
    w = (src - lo).float()
    mat = torch.zeros(n_out, n_in)
    mat[torch.arange(n_out), lo] = 1.0 - w
    mat[torch.arange(n_out), lo + 1] += w
    return mat.to(device=device, dtype=dtype)


def _resize_align_corners(x: torch.Tensor, out_h: int, out_w: int):
    """Bilinear resize of (B, C, H, W), align_corners=True."""
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    if min(h, w, out_h, out_w) > 1:
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                             align_corners=True)
    ah = _interp_matrix_ac(h, out_h, x.device, x.dtype)
    aw = _interp_matrix_ac(w, out_w, x.device, x.dtype)
    x = torch.einsum("oh,bchw->bcow", ah, x)
    return torch.einsum("pw,bcow->bcop", aw, x)


def postprocess_pointmap(raw: torch.Tensor, mode: str = "exp"):
    """raw (..., 4) -> (pts3d (..., 3), conf (...,)), float32."""
    xyz = raw[..., :3].float()
    c = raw[..., 3].float()
    if mode == "exp":
        d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
        pts = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
    elif mode == "linear":
        pts = xyz
    else:
        raise ValueError(mode)
    conf = 1.0 + torch.exp(torch.clamp(c, -10.0, 10.0))
    return pts, conf


def uv_sincos_embed(h: int, w: int, dim: int, aspect: float, device,
                    dtype=torch.float32) -> torch.Tensor:
    """VGGT's position embedding of an (h, w) feature grid: (dim, h, w).
    u and v span the grid's centres on a frame whose diagonal is 1 and
    whose width over height is ``aspect`` (the image's), each coordinate
    embedded by sin and cos at frequencies 100 ** (-j / (dim / 4)), u's
    dim / 2 channels first (vggt/heads/utils.py: `create_uv_grid`,
    `position_grid_to_embed`, `make_sincos_pos_embed`; here in float64 on
    ``device``, then cast)."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    f64 = dict(dtype=torch.float64, device=device)
    xs = torch.linspace(-span_x * (w - 1) / w, span_x * (w - 1) / w, w,
                        **f64)
    ys = torch.linspace(-span_y * (h - 1) / h, span_y * (h - 1) / h, h,
                        **f64)
    quarter = dim // 4
    omega = 1.0 / 100.0 ** (torch.arange(quarter, **f64) / quarter)

    def embed(coord):                        # (n,) -> (dim / 2, n)
        ang = omega[:, None] * coord[None]
        return torch.cat([torch.sin(ang), torch.cos(ang)]).to(dtype)

    return torch.cat([embed(xs)[:, None, :].expand(-1, h, -1),
                      embed(ys)[:, :, None].expand(-1, -1, w)])


class _ResUnit(nn.Module):
    """ResidualConvUnit: x + conv2(relu(conv1(relu(x)))). With
    ``relu_skip`` the skip carries relu(x): VGGT builds its units with
    `nn.ReLU(inplace=True)`, whose first call rewrites the unit's input
    before the add (vggt/heads/dpt_head.py `_make_fusion_block`)."""

    def __init__(self, dim: int, relu_skip: bool = False):
        super().__init__()
        self.relu_skip = relu_skip
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        y = F.relu(x)
        return (y if self.relu_skip else x) + self.conv2(
            F.relu(self.conv1(y)))


class _FusionBlock(nn.Module):
    """FeatureFusionBlock: optional skip through resConfUnit1, then
    resConfUnit2, an upsample to ``size`` (the next level's grid, which is
    twice this one's only where this one's is even: VGGT's 28 x 37 patch
    grid gives a 14 x 19 coarsest level), 1x1 out_conv. (MASt3R's
    refinenet4 receives no skip and its checkpoint still holds its
    resConfUnit1; VGGT's has none, ``has_residual=False``.)"""

    def __init__(self, dim: int, has_residual: bool = True,
                 relu_skip: bool = False):
        super().__init__()
        if has_residual:
            self.resConfUnit1 = _ResUnit(dim, relu_skip)
        self.resConfUnit2 = _ResUnit(dim, relu_skip)
        self.out_conv = nn.Conv2d(dim, dim, 1)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        h, w = x.shape[-2:]
        out_h, out_w = size if size is not None else (2 * h, 2 * w)
        return self.out_conv(_resize_align_corners(x, out_h, out_w))


class _Scratch(nn.Module):
    def __init__(self, layer_dims: Sequence[int], fd: int,
                 vggt: bool = False):
        super().__init__()
        for j in range(1, 5):
            setattr(self, f"layer{j}_rn",
                    nn.Conv2d(layer_dims[j - 1], fd, 3, padding=1, bias=False))
            setattr(self, f"refinenet{j}", _FusionBlock(
                fd, has_residual=not (vggt and j == 4), relu_skip=vggt))


class DPTHead(nn.Module):
    """Dense Prediction Transformer head over 4 hook states
    ([encoder_out, dec_mid1, dec_mid2, dec_final] in MASt3R, aggregator
    iterations 4, 11, 17, 23 in VGGT): reassemble at x4, x2, x1, x0.5 of
    the patch grid, fuse coarse to fine, predict ``out_ch`` channels at
    full image resolution.

    ``vggt``: VGGT's variant of the same layers (vggt/heads/dpt_head.py):
    0.1 x `uv_sincos_embed` added after each 1x1 projection and after the
    resize to the image, each fusion upsampled to the next level's size,
    refinenet4 without a residual unit, and the residual units' skip
    through the ReLU (`_ResUnit`)."""

    def __init__(self, token_dims: Tuple[int, int, int, int], out_ch: int = 4,
                 feature_dim: int = 256,
                 layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768),
                 last_dim: int = 128, vggt: bool = False):
        super().__init__()
        self.vggt = vggt
        ld = layer_dims
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(token_dims[0], ld[0], 1),
                          nn.ConvTranspose2d(ld[0], ld[0], 4, 4)),
            nn.Sequential(nn.Conv2d(token_dims[1], ld[1], 1),
                          nn.ConvTranspose2d(ld[1], ld[1], 2, 2)),
            nn.Sequential(nn.Conv2d(token_dims[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(token_dims[3], ld[3], 1),
                          nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)),
        ])
        self.scratch = _Scratch(ld, feature_dim, vggt)
        # indices 0/2/4 as in the checkpoint; 1 is the resize, 3 the ReLU
        self.head = nn.ModuleDict({
            "0": nn.Conv2d(feature_dim, feature_dim // 2, 3, padding=1),
            "2": nn.Conv2d(feature_dim // 2, last_dim, 3, padding=1),
            "4": nn.Conv2d(last_dim, out_ch, 1),
        })

    def forward(self, states: Sequence[torch.Tensor], hp: int, wp: int,
                img_h: int, img_w: int) -> torch.Tensor:
        """states: 4 x (B, T, C). Returns (B, H, W, out_ch) float32."""
        aspect = img_w / img_h
        feats = []
        for i, s in enumerate(states):
            f = s.transpose(1, 2).reshape(s.shape[0], -1, hp, wp)
            proj, *resize = self.act_postprocess[i]
            f = proj(f)
            if self.vggt:
                f = f + 0.1 * uv_sincos_embed(hp, wp, f.shape[1], aspect,
                                              f.device, f.dtype)
            for m in resize:
                f = m(f)
            feats.append(getattr(self.scratch, f"layer{i + 1}_rn")(f))
        sc = self.scratch
        # VGGT fuses to each next level's size; MASt3R keeps the
        # reference's 2x, and so its failure on an odd patch grid
        size = (lambda f: f.shape[-2:]) if self.vggt else (lambda f: None)
        x = sc.refinenet4(feats[3], size=size(feats[2]))
        x = sc.refinenet3(x, feats[2], size=size(feats[1]))
        x = sc.refinenet2(x, feats[1], size=size(feats[0]))
        x = sc.refinenet1(x, feats[0])
        x = self.head["0"](x)
        x = _resize_align_corners(x, img_h, img_w)
        if self.vggt:
            x = x + 0.1 * uv_sincos_embed(img_h, img_w, x.shape[1], aspect,
                                          x.device, x.dtype)
        x = F.relu(self.head["2"](x))
        with torch.autocast(x.device.type, enabled=False):
            x = self.head["4"](x.float())
        return x.permute(0, 2, 3, 1)


class DescriptorHead(nn.Module):
    """The local-feature MLP: Mlp(idim, 4*idim, (desc_dim+1)*p^2) over
    [encoder || decoder] tokens, pixel-shuffled to full resolution;
    desc_dim L2-normalised channels plus one confidence channel."""

    def __init__(self, idim: int, desc_dim: int = 24, patch_size: int = 16,
                 hidden_factor: float = 4.0):
        super().__init__()
        self.desc_dim = desc_dim
        self.patch_size = patch_size
        self.fc1 = nn.Linear(idim, int(hidden_factor * idim))
        self.fc2 = nn.Linear(int(hidden_factor * idim),
                             (desc_dim + 1) * patch_size ** 2)

    def forward(self, enc_tokens, dec_tokens, hp: int, wp: int):
        x = torch.cat([enc_tokens, dec_tokens], dim=-1)
        x = F.gelu(self.fc1(x))
        with torch.autocast(x.device.type, enabled=False):
            x = self.fc2(x.float())
        b = x.shape[0]
        x = x.transpose(-1, -2).reshape(b, -1, hp, wp)
        x = F.pixel_shuffle(x, self.patch_size).permute(0, 2, 3, 1)
        desc = x[..., : self.desc_dim]
        desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1,
                                                    keepdim=True), min=1e-8)
        desc_conf = 1.0 + torch.exp(torch.clamp(x[..., -1], -10.0, 10.0))
        return desc, desc_conf


class DownstreamHead(nn.Module):
    """One view's heads (`downstream_head{v}` in the checkpoint)."""

    def __init__(self, cfg):
        super().__init__()
        token_dims = (cfg.enc_dim, cfg.dec_dim, cfg.dec_dim, cfg.dec_dim)
        self.dpt = DPTHead(token_dims, 4, cfg.dpt_feature_dim,
                           cfg.dpt_layer_dims, cfg.dpt_last_dim)
        self.head_local_features = DescriptorHead(
            cfg.enc_dim + cfg.dec_dim, cfg.desc_dim, cfg.patch_size,
            cfg.desc_hidden_factor)
