"""Plain PyTorch reference of the MASt3R two-view network (ViT encoder,
CroCo interleaved decoder, DPT pointmap heads, local-feature MLP heads),
written from the published description (naver/croco, naver/dust3r,
naver/mast3r: `AsymmetricMASt3R` with `catmlp+dpt` heads) in float32.

It reads weights under the public checkpoint's key names
(`enc_blocks.{i}.attn.qkv.weight`, `downstream_head1.dpt.scratch...`) from
a plain dict of tensors, and imports nothing of the program under test.

Conventions it follows (those of the published code):
  - pre-LN blocks, LayerNorm eps 1e-5, exact (erf) GELU;
  - 2D RoPE on every self- and cross-attention q and k: the head dim splits
    into a y half and an x half, each rotated in rotate-half pairs with
    frequencies 100 ** (-j / (D/4));
  - the decoder's cross-attention memory is LayerNormed (`norm_y`), block i
    of each stream reads both streams' block i-1 outputs, and one final
    LayerNorm closes both;
  - DPT hooks at the encoder output and decoder blocks depth/2, 3 depth/4
    and the last; bilinear resizes with align_corners=True;
  - pointmaps `exp` parameterised, confidences 1 + exp(clip(x, -10, 10)),
    descriptors L2-normalised after a pixel shuffle.

``quant``: None computes every matmul and convolution in float32; a
callable is applied to both operands of each of them first (the control's
lower precision, `reference.precision`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

OUT_KEYS = ("pts1", "conf1", "pts2", "conf2", "desc1", "desc2",
            "desc_conf1", "desc_conf2")


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter of the network as (checkpoint key, shape, kind),
    kind "weight" (fan-in-scaled normal), "bias" (zeros), "ln_w" (ones),
    "ln_b" (zeros) or "dead" (zeros: the mask token and refinenet4's
    first residual unit, which the forward never reads)."""
    e, d, p = cfg["enc_embed_dim"], cfg["dec_embed_dim"], cfg["patch_size"]
    hid_e, hid_d = int(e * cfg["mlp_ratio"]), int(d * cfg["mlp_ratio"])
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def lin(name, o, i):
        out.append((f"{name}.weight", (o, i), "weight"))
        out.append((f"{name}.bias", (o,), "bias"))

    def conv(name, o, i, k, bias=True, kind="weight"):
        out.append((f"{name}.weight", (o, i, k, k), kind))
        if bias:
            out.append((f"{name}.bias", (o,), "bias" if kind != "dead"
                        else "dead"))

    def ln(name, n):
        out.append((f"{name}.weight", (n,), "ln_w"))
        out.append((f"{name}.bias", (n,), "ln_b"))

    out.append(("mask_token", (1, 1, d), "dead"))
    conv("patch_embed.proj", e, 3, p)
    for i in range(cfg["enc_depth"]):
        b = f"enc_blocks.{i}"
        ln(f"{b}.norm1", e)
        lin(f"{b}.attn.qkv", 3 * e, e)
        lin(f"{b}.attn.proj", e, e)
        ln(f"{b}.norm2", e)
        lin(f"{b}.mlp.fc1", hid_e, e)
        lin(f"{b}.mlp.fc2", e, hid_e)
    ln("enc_norm", e)
    lin("decoder_embed", d, e)
    for stack in ("dec_blocks", "dec_blocks2"):
        for i in range(cfg["dec_depth"]):
            b = f"{stack}.{i}"
            ln(f"{b}.norm1", d)
            lin(f"{b}.attn.qkv", 3 * d, d)
            lin(f"{b}.attn.proj", d, d)
            lin(f"{b}.cross_attn.projq", d, d)
            lin(f"{b}.cross_attn.projk", d, d)
            lin(f"{b}.cross_attn.projv", d, d)
            lin(f"{b}.cross_attn.proj", d, d)
            ln(f"{b}.norm2", d)
            ln(f"{b}.norm3", d)
            ln(f"{b}.norm_y", d)
            lin(f"{b}.mlp.fc1", hid_d, d)
            lin(f"{b}.mlp.fc2", d, hid_d)
    ln("dec_norm", d)
    ld = cfg["dpt_layer_dims"]
    fd, last = cfg["dpt_feature_dim"], cfg["dpt_last_dim"]
    desc = cfg["local_feat_dim"]
    idim = e + d
    hid_l = int(cfg["desc_hidden_factor"] * idim)
    for v in (1, 2):
        h = f"downstream_head{v}"
        a = f"{h}.dpt.act_postprocess"
        tok = (e, d, d, d)
        conv(f"{a}.0.0", ld[0], tok[0], 1)
        conv(f"{a}.0.1", ld[0], ld[0], 4)      # ConvTranspose2d (in, out)
        conv(f"{a}.1.0", ld[1], tok[1], 1)
        conv(f"{a}.1.1", ld[1], ld[1], 2)      # ConvTranspose2d
        conv(f"{a}.2.0", ld[2], tok[2], 1)
        conv(f"{a}.3.0", ld[3], tok[3], 1)
        conv(f"{a}.3.1", ld[3], ld[3], 3)
        s = f"{h}.dpt.scratch"
        for j in range(1, 5):
            conv(f"{s}.layer{j}_rn", fd, ld[j - 1], 3, bias=False)
            for unit in ("resConfUnit1", "resConfUnit2"):
                kind = "dead" if (j == 4 and unit == "resConfUnit1") \
                    else "weight"
                conv(f"{s}.refinenet{j}.{unit}.conv1", fd, fd, 3, kind=kind)
                conv(f"{s}.refinenet{j}.{unit}.conv2", fd, fd, 3, kind=kind)
            conv(f"{s}.refinenet{j}.out_conv", fd, fd, 1)
        conv(f"{h}.dpt.head.0", fd // 2, fd, 3)
        conv(f"{h}.dpt.head.2", last, fd // 2, 3)
        conv(f"{h}.dpt.head.4", 4, last, 1)
        lin(f"{h}.head_local_features.fc1", hid_l, idim)
        lin(f"{h}.head_local_features.fc2", (desc + 1) * p * p, hid_l)
    return out


def fan_in(key: str, shape: Tuple[int, ...]) -> int:
    """The fan-in of a weight: the input channels times the kernel for a
    linear or convolution, the first axis for a transposed convolution
    (the act_postprocess up-samplers, stored (in, out, k, k))."""
    if ".act_postprocess.0.1." in key or ".act_postprocess.1.1." in key:
        return shape[0]
    return int(math.prod(shape[1:]))


class Net:
    """The reference forward over a weights dict ``w`` (checkpoint keys)."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict,
                 quant: Quant = None):
        self.w, self.cfg, self.q = w, cfg, quant or (lambda t: t)

    # -- primitives -------------------------------------------------------
    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.w[name + ".weight"]),
                        self.w[name + ".bias"])

    def conv(self, x, name, stride=1, padding=0, bias=True):
        b = self.w[name + ".bias"] if bias else None
        return F.conv2d(self.q(x), self.q(self.w[name + ".weight"]), b,
                        stride=stride, padding=padding)

    def conv_t(self, x, name, k):
        return F.conv_transpose2d(self.q(x), self.q(self.w[name + ".weight"]),
                                  self.w[name + ".bias"], stride=k)

    def ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"],
                            self.w[name + ".bias"], 1e-5)

    @staticmethod
    def rope(x, pos, base=100.0):
        """x (B, T, H, D); pos (T, 2) integer (y, x)."""
        dim = x.shape[-1]
        quarter = dim // 4
        inv = base ** (-torch.arange(quarter, dtype=torch.float32,
                                     device=x.device) / quarter)
        out = []
        for half, coord in ((x[..., :dim // 2], pos[:, 0]),
                            (x[..., dim // 2:], pos[:, 1])):
            ang = coord.float()[:, None] * inv[None]            # (T, D/4)
            cos = torch.cos(ang).repeat(1, 2)[None, :, None]
            sin = torch.sin(ang).repeat(1, 2)[None, :, None]
            a, b = half[..., :quarter], half[..., quarter:]
            rot = torch.cat([-b, a], -1)
            out.append(half * cos + rot * sin)
        return torch.cat(out, -1)

    def attend(self, q, k, v):
        """q (B, Tq, H, D), k/v (B, Tk, H, D) -> (B, Tq, H*D)."""
        s = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k))
        p = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", self.q(p), self.q(v))
        return o.reshape(o.shape[0], o.shape[1], -1)

    def self_attn(self, x, name, heads, pos):
        b, t, c = x.shape
        qkv = self.linear(x, name + ".qkv").reshape(b, t, 3, heads, c // heads)
        q, k, v = qkv.unbind(2)
        o = self.attend(self.rope(q, pos), self.rope(k, pos), v)
        return self.linear(o, name + ".proj")

    def cross_attn(self, x, y, name, heads, pos):
        b, t, c = x.shape
        sh = (b, -1, heads, c // heads)
        q = self.linear(x, name + ".projq").reshape(sh)
        k = self.linear(y, name + ".projk").reshape(sh)
        v = self.linear(y, name + ".projv").reshape(sh)
        o = self.attend(self.rope(q, pos), self.rope(k, pos), v)
        return self.linear(o, name + ".proj")

    def mlp(self, x, name):
        return self.linear(F.gelu(self.linear(x, name + ".fc1")),
                           name + ".fc2")

    # -- the network ------------------------------------------------------
    def encode(self, img, pos):
        cfg = self.cfg
        x = self.conv(img, "patch_embed.proj", stride=cfg["patch_size"])
        x = x.flatten(2).transpose(1, 2)
        for i in range(cfg["enc_depth"]):
            b = f"enc_blocks.{i}"
            x = x + self.self_attn(self.ln(x, b + ".norm1"), b + ".attn",
                                   cfg["enc_num_heads"], pos)
            x = x + self.mlp(self.ln(x, b + ".norm2"), b + ".mlp")
        return self.ln(x, "enc_norm")

    def dec_block(self, x, y, name, pos):
        h = self.cfg["dec_num_heads"]
        x = x + self.self_attn(self.ln(x, name + ".norm1"), name + ".attn",
                               h, pos)
        x = x + self.cross_attn(self.ln(x, name + ".norm2"),
                                self.ln(y, name + ".norm_y"),
                                name + ".cross_attn", h, pos)
        return x + self.mlp(self.ln(x, name + ".norm3"), name + ".mlp")

    def decode(self, f1, f2, pos):
        x1 = self.linear(f1, "decoder_embed")
        x2 = self.linear(f2, "decoder_embed")
        s1, s2 = [x1], [x2]
        for i in range(self.cfg["dec_depth"]):
            x1, x2 = (self.dec_block(x1, x2, f"dec_blocks.{i}", pos),
                      self.dec_block(x2, x1, f"dec_blocks2.{i}", pos))
            s1.append(x1)
            s2.append(x2)
        s1[-1] = self.ln(s1[-1], "dec_norm")
        s2[-1] = self.ln(s2[-1], "dec_norm")
        return s1, s2

    def res_unit(self, x, name):
        y = self.conv(F.relu(x), name + ".conv1", padding=1)
        return x + self.conv(F.relu(y), name + ".conv2", padding=1)

    def fusion(self, x, name, skip=None):
        if skip is not None:
            x = x + self.res_unit(skip, name + ".resConfUnit1")
        x = self.res_unit(x, name + ".resConfUnit2")
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        return self.conv(x, name + ".out_conv")

    def dpt(self, states, v, hp, wp, h, w):
        a = f"downstream_head{v}.dpt.act_postprocess"
        s = f"downstream_head{v}.dpt.scratch"
        grids = [t.transpose(1, 2).reshape(t.shape[0], -1, hp, wp)
                 for t in states]
        f0 = self.conv_t(self.conv(grids[0], f"{a}.0.0"), f"{a}.0.1", 4)
        f1 = self.conv_t(self.conv(grids[1], f"{a}.1.0"), f"{a}.1.1", 2)
        f2 = self.conv(grids[2], f"{a}.2.0")
        f3 = self.conv(self.conv(grids[3], f"{a}.3.0"), f"{a}.3.1", stride=2,
                       padding=1)
        feats = [self.conv(f, f"{s}.layer{j + 1}_rn", padding=1, bias=False)
                 for j, f in enumerate((f0, f1, f2, f3))]
        x = self.fusion(feats[3], f"{s}.refinenet4")
        x = self.fusion(x, f"{s}.refinenet3", feats[2])
        x = self.fusion(x, f"{s}.refinenet2", feats[1])
        x = self.fusion(x, f"{s}.refinenet1", feats[0])
        hd = f"downstream_head{v}.dpt.head"
        x = self.conv(x, f"{hd}.0", padding=1)
        x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)
        x = F.relu(self.conv(x, f"{hd}.2", padding=1))
        return self.conv(x, f"{hd}.4").permute(0, 2, 3, 1)

    def local_features(self, enc, dec, v, hp, wp):
        name = f"downstream_head{v}.head_local_features"
        x = torch.cat([enc, dec], -1)
        x = self.linear(F.gelu(self.linear(x, name + ".fc1")), name + ".fc2")
        p = self.cfg["patch_size"]
        x = x.transpose(1, 2).reshape(x.shape[0], -1, hp, wp)
        x = F.pixel_shuffle(x, p).permute(0, 2, 3, 1)
        dd = self.cfg["local_feat_dim"]
        desc = F.normalize(x[..., :dd], dim=-1, eps=1e-8)
        return desc, 1.0 + torch.exp(torch.clamp(x[..., dd], -10.0, 10.0))

    def forward(self, img1, img2) -> Dict[str, torch.Tensor]:
        """img1, img2 (B, 3, H, W) in [-1, 1] -> the eight outputs."""
        cfg = self.cfg
        b, _, h, w = img1.shape
        p = cfg["patch_size"]
        hp, wp = h // p, w // p
        ys, xs = torch.meshgrid(torch.arange(hp, device=img1.device),
                                torch.arange(wp, device=img1.device),
                                indexing="ij")
        pos = torch.stack([ys.reshape(-1), xs.reshape(-1)], -1)
        feats = self.encode(torch.cat([img1, img2]), pos)
        f1, f2 = feats[:b], feats[b:]
        s1, s2 = self.decode(f1, f2, pos)
        depth = cfg["dec_depth"]
        k1, k2 = max(1, depth // 2), max(1, (3 * depth) // 4)
        out = {}
        for v, f, s in (("1", f1, s1), ("2", f2, s2)):
            raw = self.dpt([f, s[k1], s[k2], s[-1]], v, hp, wp, h, w)
            xyz = raw[..., :3]
            d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
            out["pts" + v] = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
            out["conf" + v] = 1.0 + torch.exp(torch.clamp(raw[..., 3],
                                                          -10.0, 10.0))
            out["desc" + v], out["desc_conf" + v] = self.local_features(
                f, s[-1], v, hp, wp)
        return out
