"""Plain PyTorch reference of VGGT (Wang et al., CVPR 2025,
arXiv:2503.11651; facebookresearch/vggt, `facebook/VGGT-1B`) without its
track head, written from the published code's description in float32:
the DINOv2 ViT-L/14 encoder with registers, the alternating frame and
global attention of the aggregator, the camera head and the two DPT
heads, the pose encoding's cameras, and the unprojection of depth with
the cross-view clean-up. It reads weights from a plain dict under the
program's state-dict keys (`layout`) and imports nothing of the program
under test. (`tests/vggt_reference.py` is a copy, for the CPU tests.)

Conventions it follows (those of the published code):
  - images (S, 3, H, W) in [0, 1], ImageNet-normalised inside; DINOv2's
    37 x 37 position table resampled bicubic with antialiasing, rows to
    rows; cls, 4 registers, patches; LayerNorm eps 1e-6 in DINOv2, 1e-5
    elsewhere (qk-norm over the head dim included); exact GELU;
    LayerScale on both branches of every block;
  - the aggregator's tokens per view [camera, 4 registers, patches], view
    0 from index 0 of the token tables and the others from index 1; RoPE
    2D at frequency 100 on q and k after the qk-norm, patch positions
    (y + 1, x + 1), special tokens 0, the head dim split into a y half
    and an x half, each rotated in rotate-half pairs;
  - iteration i's output [frame out, global out]; the camera head reads
    the last one's camera tokens, the DPT heads iterations `head_layers`'
    patch tokens after a LayerNorm;
  - the camera head's adaLN: tokens' = gate (LN(t) (1 + scale) + shift)
    + t from the previous encoding (empty pose tokens first), 4 blocks,
    the trunk norm, an MLP to 9, accumulated; FoV through a ReLU;
  - DPT: 1 x 1 projections plus 0.1 x the uv sin-cos embedding, resizes
    x4, x2, x1, x0.5, fusion coarse to fine, each upsampled (bilinear,
    align_corners) to the next level's size, the residual units' skip
    through the ReLU (the published in-place ReLU), the output
    convolution, the resize to the image plus the embedding again;
    depth exp, points sign(x) (e^|x| - 1), confidences 1 + exp.

``quant``: None computes every matmul and convolution in float32; a
callable is applied to both operands of each matmul of the encoder and
the aggregator first, attention's two products included (the control's
lower precision, `reference.precision`). Attention runs one head and
one block of queries at a time where the score matrix would be large,
so the global attention of 33,312 tokens fits.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]

OUT_KEYS = ("pose_enc", "depth", "depth_conf", "world_points",
            "world_points_conf")
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# the pose branch's last bias of the random weights (`layout`)
POSE_BIAS = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.25, 0.25)
# the qk-norm's gain of the random weights (`layout`)
QK_GAIN = 2.0
# score-matrix elements one attention call may hold at once
SCORE_BLOCK = 1 << 26


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter as (key, shape, kind): "weight" (normal, 1/sqrt
    (fan-in)), "bias", "ln_b" and "dead" (zeros), "ln_w" and "gamma"
    (ones), "qk_w" (`QK_GAIN`: the qk-norm's weight), "token" (normal, 1:
    the camera, register and cls tokens, the position table, the empty
    pose tokens), "pose_w" (normal, 0.1/sqrt(fan-in)) and "pose_b"
    (`POSE_BIAS`): the pose branch's last layer."""
    c, p = cfg["embed_dim"], cfg["patch_size"]
    r = cfg["num_register_tokens"]
    m = cfg["img_size"] // p
    d = 2 * c
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def lin(name, o, i, kinds=("weight", "bias")):
        out.append((f"{name}.weight", (o, i), kinds[0]))
        out.append((f"{name}.bias", (o,), kinds[1]))

    def conv(name, o, i, k, bias=True):
        out.append((f"{name}.weight", (o, i, k, k), "weight"))
        if bias:
            out.append((f"{name}.bias", (o,), "bias"))

    def ln(name, n, kind="ln_w"):
        out.append((f"{name}.weight", (n,), kind))
        out.append((f"{name}.bias", (n,), "ln_b"))

    def block(name, n, mlp, qk_norm):
        hd = n // cfg["num_heads"]
        ln(f"{name}.norm1", n)
        lin(f"{name}.attn.qkv", 3 * n, n)
        if qk_norm:
            ln(f"{name}.attn.q_norm", hd, "qk_w")
            ln(f"{name}.attn.k_norm", hd, "qk_w")
        lin(f"{name}.attn.proj", n, n)
        out.append((f"{name}.ls1.gamma", (n,), "gamma"))
        ln(f"{name}.norm2", n)
        lin(f"{name}.mlp.fc1", mlp, n)
        lin(f"{name}.mlp.fc2", n, mlp)
        out.append((f"{name}.ls2.gamma", (n,), "gamma"))

    hid = int(c * cfg["mlp_ratio"])
    e = "aggregator.patch_embed"
    out.append((f"{e}.cls_token", (1, 1, c), "token"))
    out.append((f"{e}.pos_embed", (1, 1 + m * m, c), "token"))
    out.append((f"{e}.register_tokens", (1, r, c), "token"))
    out.append((f"{e}.mask_token", (1, c), "dead"))
    conv(f"{e}.patch_embed.proj", c, 3, p)
    for i in range(cfg["enc_depth"]):
        block(f"{e}.blocks.{i}", c, hid, False)
    ln(f"{e}.norm", c)
    out.append(("aggregator.camera_token", (1, 2, 1, c), "token"))
    out.append(("aggregator.register_token", (1, 2, r, c), "token"))
    for stack in ("frame_blocks", "global_blocks"):
        for i in range(cfg["depth"]):
            block(f"aggregator.{stack}.{i}", c, hid, True)
    h = "camera_head"
    for i in range(cfg["camera_trunk_depth"]):
        block(f"{h}.trunk.{i}", d, 4 * d, False)
    ln(f"{h}.token_norm", d)
    ln(f"{h}.trunk_norm", d)
    out.append((f"{h}.empty_pose_tokens", (1, 1, 9), "token"))
    lin(f"{h}.embed_pose", d, 9)
    lin(f"{h}.poseLN_modulation.1", 3 * d, d)
    lin(f"{h}.pose_branch.fc1", c, d)
    lin(f"{h}.pose_branch.fc2", 9, c, ("pose_w", "pose_b"))
    ld, fd = cfg["dpt_out_channels"], cfg["dpt_features"]
    for head, n_out in (("depth_head", 2), ("point_head", 4)):
        ln(f"{head}.norm", d)
        a = f"{head}.dpt.act_postprocess"
        conv(f"{a}.0.0", ld[0], d, 1)
        conv(f"{a}.0.1", ld[0], ld[0], 4)        # ConvTranspose2d (in, out)
        conv(f"{a}.1.0", ld[1], d, 1)
        conv(f"{a}.1.1", ld[1], ld[1], 2)        # ConvTranspose2d
        conv(f"{a}.2.0", ld[2], d, 1)
        conv(f"{a}.3.0", ld[3], d, 1)
        conv(f"{a}.3.1", ld[3], ld[3], 3)
        s = f"{head}.dpt.scratch"
        for j in range(1, 5):
            conv(f"{s}.layer{j}_rn", fd, ld[j - 1], 3, bias=False)
            units = ("resConfUnit2",) if j == 4 else ("resConfUnit1",
                                                       "resConfUnit2")
            for unit in units:
                conv(f"{s}.refinenet{j}.{unit}.conv1", fd, fd, 3)
                conv(f"{s}.refinenet{j}.{unit}.conv2", fd, fd, 3)
            conv(f"{s}.refinenet{j}.out_conv", fd, fd, 1)
        conv(f"{head}.dpt.head.0", fd // 2, fd, 3)
        conv(f"{head}.dpt.head.2", cfg["dpt_last_dim"], fd // 2, 3)
        conv(f"{head}.dpt.head.4", n_out, cfg["dpt_last_dim"], 1)
    return out


def fan_in(key: str, shape: Tuple[int, ...]) -> int:
    """The input channels times the kernel; the first axis of a transposed
    convolution (stored (in, out, k, k))."""
    if ".act_postprocess.0.1." in key or ".act_postprocess.1.1." in key:
        return shape[0]
    return int(math.prod(shape[1:]))


def random_weights(cfg: dict, gen: torch.Generator, device) -> Dict:
    """`layout`'s weights from ``gen``, one draw a tensor in layout
    order."""
    out = {}
    for key, shape, kind in layout(cfg):
        if kind in ("weight", "pose_w", "token"):
            w = torch.randn(shape, generator=gen, device=device)
            if kind != "token":
                w *= (0.1 if kind == "pose_w" else 1.0) \
                    / math.sqrt(fan_in(key, shape))
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


def uv_embed(h: int, w: int, dim: int, aspect: float,
             device) -> torch.Tensor:
    """(dim, h, w): the uv grid of an (h, w) map on a frame of diagonal 1
    and aspect W / H, sin and cos of each coordinate at frequencies
    100 ** (-j / (dim / 4)), u first; float64, then float32."""
    diag = math.sqrt(aspect * aspect + 1.0)
    sx, sy = aspect / diag, 1.0 / diag
    f64 = dict(dtype=torch.float64, device=device)
    u = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w, **f64)
    v = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h, **f64)
    n = dim // 4
    om = 100.0 ** (-torch.arange(n, **f64) / n)
    eu = torch.cat([torch.sin(u[:, None] * om), torch.cos(u[:, None] * om)],
                   -1)                                       # (w, dim/2)
    ev = torch.cat([torch.sin(v[:, None] * om), torch.cos(v[:, None] * om)],
                   -1)                                       # (h, dim/2)
    emb = torch.cat([eu[None].expand(h, -1, -1),
                     ev[:, None].expand(-1, w, -1)], -1)
    return emb.permute(2, 0, 1).float()


class VGGT:
    """The reference forward over a weights dict ``w``."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict,
                 quant: Quant = None):
        self.w, self.cfg = w, cfg
        self.qa = quant or (lambda t: t)

    # -- primitives -------------------------------------------------------
    def linear(self, x, name, q):
        return F.linear(q(x), q(self.w[name + ".weight"]),
                        self.w[name + ".bias"])

    def conv(self, x, name, stride=1, padding=0, bias=True):
        b = self.w[name + ".bias"] if bias else None
        return F.conv2d(x, self.w[name + ".weight"], b, stride=stride,
                        padding=padding)

    def ln(self, x, name, eps=1e-5):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"],
                            self.w[name + ".bias"], eps)

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
            out.append(half * cos + torch.cat([-b, a], -1) * sin)
        return torch.cat(out, -1)

    def attend(self, q, k, v, quant):
        """q, k, v (B, T, H, D) -> (B, T, H*D): softmax(q k^T / sqrt(D)) v,
        a head and a block of queries at a time past SCORE_BLOCK."""
        b, t, h, d = q.shape
        rows = max(1, SCORE_BLOCK // (b * t))
        out = torch.empty_like(q)
        for j in range(h):
            kj, vj = quant(k[:, :, j]), quant(v[:, :, j])
            for r0 in range(0, t, rows):
                s = torch.einsum("bqd,bkd->bqk", quant(q[:, r0:r0 + rows, j]),
                                 kj)
                p = torch.softmax(s / math.sqrt(d), dim=-1)
                out[:, r0:r0 + rows, j] = torch.einsum("bqk,bkd->bqd",
                                                       quant(p), vj)
        return out.reshape(b, t, h * d)

    def block(self, x, name, heads, eps, pos=None, quant=None):
        """A pre-LN block with LayerScale; qk-norm and RoPE where ``pos``
        is given."""
        quant = quant or (lambda t: t)
        b, t, c = x.shape
        y = self.ln(x, name + ".norm1", eps)
        qkv = self.linear(y, name + ".attn.qkv", quant)
        q, k, v = qkv.reshape(b, t, 3, heads, c // heads).unbind(2)
        if pos is not None:
            q = self.rope(self.ln(q, name + ".attn.q_norm"), pos)
            k = self.rope(self.ln(k, name + ".attn.k_norm"), pos)
        o = self.linear(self.attend(q, k, v, quant), name + ".attn.proj",
                        quant)
        x = x + o * self.w[name + ".ls1.gamma"]
        y = self.ln(x, name + ".norm2", eps)
        y = self.linear(F.gelu(self.linear(y, name + ".mlp.fc1", quant)),
                        name + ".mlp.fc2", quant)
        return x + y * self.w[name + ".ls2.gamma"]

    # -- the network ------------------------------------------------------
    def encode(self, img):
        """DINOv2: normalised images (S, 3, H, W) -> patch tokens."""
        cfg, e = self.cfg, "aggregator.patch_embed"
        p = cfg["patch_size"]
        s, _, h, w = img.shape
        hp, wp = h // p, w // p
        wt = self.w[f"{e}.patch_embed.proj.weight"]
        x = F.conv2d(self.qa(img), self.qa(wt),
                     self.w[f"{e}.patch_embed.proj.bias"], stride=p)
        x = x.flatten(2).transpose(1, 2)
        pe = self.w[f"{e}.pos_embed"]
        m = int(round(math.sqrt(pe.shape[1] - 1)))
        grid = pe[:, 1:]
        if (hp, wp) != (m, m):
            g = F.interpolate(grid.reshape(1, m, m, -1).permute(0, 3, 1, 2),
                              size=(hp, wp), mode="bicubic", antialias=True)
            grid = g.permute(0, 2, 3, 1).reshape(1, hp * wp, -1)
        x = torch.cat([self.w[f"{e}.cls_token"].expand(s, -1, -1), x], 1) \
            + torch.cat([pe[:, :1], grid], 1)
        x = torch.cat([x[:, :1],
                       self.w[f"{e}.register_tokens"].expand(s, -1, -1),
                       x[:, 1:]], 1)
        for i in range(cfg["enc_depth"]):
            x = self.block(x, f"{e}.blocks.{i}", cfg["num_heads"], 1e-6,
                           quant=self.qa)
        x = self.ln(x, f"{e}.norm", 1e-6)
        return x[:, 1 + cfg["num_register_tokens"]:]

    def aggregate(self, images):
        """images (S, 3, H, W) in [0, 1] -> {iteration: (S, P, 2 C)}."""
        cfg = self.cfg
        dev = images.device
        mean = torch.tensor(MEAN, device=dev).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=dev).view(1, 3, 1, 1)
        patches = self.encode((images - mean) / std)
        s, _, h, w = images.shape
        p = cfg["patch_size"]
        hp, wp = h // p, w // p
        cam = self.w["aggregator.camera_token"][0]            # (2, 1, C)
        reg = self.w["aggregator.register_token"][0]          # (2, R, C)
        special = torch.cat([cam, reg], 1)
        special = torch.cat([special[:1],
                             special[1:].expand(s - 1, -1, -1)], 0)
        x = torch.cat([special, patches], 1)
        n_special = special.shape[1]
        ys, xs = torch.meshgrid(torch.arange(hp, device=dev),
                                torch.arange(wp, device=dev), indexing="ij")
        pos = torch.cat([torch.zeros(n_special, 2, dtype=torch.long,
                                     device=dev),
                         torch.stack([ys.reshape(-1), xs.reshape(-1)], -1)
                         + 1])
        pos_all = pos.repeat(s, 1)
        keep = set(cfg["head_layers"]) | {cfg["depth"] - 1}
        out = {}
        heads = cfg["num_heads"]
        n_tok, c = x.shape[1], x.shape[2]
        for i in range(cfg["depth"]):
            x = self.block(x, f"aggregator.frame_blocks.{i}", heads, 1e-5,
                           pos, self.qa)
            frame = x
            x = self.block(x.reshape(1, s * n_tok, c),
                           f"aggregator.global_blocks.{i}", heads, 1e-5,
                           pos_all, self.qa).reshape(s, n_tok, c)
            if i in keep:
                out[i] = torch.cat([frame, x], -1)
        return out

    def camera(self, tokens):
        """The last iteration's camera tokens (S, 2 C) -> each iteration's
        activated encoding (S, 9)."""
        cfg, h = self.cfg, "camera_head"
        t = self.ln(tokens, f"{h}.token_norm")[None]
        one = lambda x: x
        enc, outs = None, []
        for _ in range(cfg["camera_iterations"]):
            src = (self.w[f"{h}.empty_pose_tokens"].expand(1, t.shape[1], -1)
                   if enc is None else enc)
            mod = self.linear(F.silu(self.linear(src, f"{h}.embed_pose", one)),
                              f"{h}.poseLN_modulation.1", one)
            shift, scale, gate = mod.chunk(3, -1)
            norm = F.layer_norm(t, t.shape[-1:], eps=1e-6)
            x = gate * (norm * (1.0 + scale) + shift) + t
            for i in range(cfg["camera_trunk_depth"]):
                x = self.block(x, f"{h}.trunk.{i}", cfg["camera_num_heads"],
                               1e-5)
            x = self.ln(x, f"{h}.trunk_norm")
            delta = self.linear(F.gelu(self.linear(x, f"{h}.pose_branch.fc1",
                                                   one)),
                                f"{h}.pose_branch.fc2", one)
            enc = delta if enc is None else enc + delta
            outs.append(torch.cat([enc[..., :7], F.relu(enc[..., 7:])],
                                  -1)[0])
        return outs

    def res_unit(self, x, name):
        x = F.relu(x)           # the published in-place ReLU: the skip too
        y = self.conv(x, name + ".conv1", padding=1)
        return x + self.conv(F.relu(y), name + ".conv2", padding=1)

    def fusion(self, x, name, skip=None, size=None):
        if skip is not None:
            x = x + self.res_unit(skip, name + ".resConfUnit1")
        x = self.res_unit(x, name + ".resConfUnit2")
        size = size or (2 * x.shape[-2], 2 * x.shape[-1])
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=True)
        return self.conv(x, name + ".out_conv")

    def dpt(self, states, head, hp, wp, h, w):
        """states 4 x (B, hp wp, 2 C) patch tokens -> (B, H, W, out)."""
        a, s = f"{head}.dpt.act_postprocess", f"{head}.dpt.scratch"
        aspect = w / h
        feats = []
        for j, t in enumerate(states):
            t = self.ln(t, f"{head}.norm")
            g = t.transpose(1, 2).reshape(t.shape[0], -1, hp, wp)
            g = self.conv(g, f"{a}.{j}.0")
            g = g + 0.1 * uv_embed(hp, wp, g.shape[1], aspect, g.device)
            if j == 0:
                g = F.conv_transpose2d(g, self.w[f"{a}.0.1.weight"],
                                       self.w[f"{a}.0.1.bias"], stride=4)
            elif j == 1:
                g = F.conv_transpose2d(g, self.w[f"{a}.1.1.weight"],
                                       self.w[f"{a}.1.1.bias"], stride=2)
            elif j == 3:
                g = self.conv(g, f"{a}.3.1", stride=2, padding=1)
            feats.append(self.conv(g, f"{s}.layer{j + 1}_rn", padding=1,
                                   bias=False))
        size = lambda f: tuple(f.shape[-2:])
        x = self.fusion(feats[3], f"{s}.refinenet4", size=size(feats[2]))
        x = self.fusion(x, f"{s}.refinenet3", feats[2], size(feats[1]))
        x = self.fusion(x, f"{s}.refinenet2", feats[1], size(feats[0]))
        x = self.fusion(x, f"{s}.refinenet1", feats[0])
        x = self.conv(x, f"{head}.dpt.head.0", padding=1)
        x = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)
        x = x + 0.1 * uv_embed(h, w, x.shape[1], aspect, x.device)
        x = F.relu(self.conv(x, f"{head}.dpt.head.2", padding=1))
        return self.conv(x, f"{head}.dpt.head.4").permute(0, 2, 3, 1)

    def forward(self, images) -> Dict[str, torch.Tensor]:
        """images (S, 3, H, W) in [0, 1] -> pose_enc (S, 9), pose_enc_list,
        depth (S, H, W, 1), depth_conf, world_points (S, H, W, 3),
        world_points_conf, and the aggregator's kept iterations
        (``tokens``)."""
        cfg = self.cfg
        s, _, h, w = images.shape
        p = cfg["patch_size"]
        hp, wp = h // p, w // p
        tokens = self.aggregate(images)
        encs = self.camera(tokens[cfg["depth"] - 1][:, 0])
        start = 1 + cfg["num_register_tokens"]
        chunk = cfg["frames_chunk_size"]
        raw = {"depth_head": [], "point_head": []}
        for c0 in range(0, s, chunk):
            states = [tokens[i][c0:c0 + chunk, start:]
                      for i in cfg["head_layers"]]
            for head in raw:
                raw[head].append(self.dpt(states, head, hp, wp, h, w))
        rd, rp = torch.cat(raw["depth_head"]), torch.cat(raw["point_head"])
        xyz = rp[..., :3]
        return {"pose_enc": encs[-1], "pose_enc_list": encs,
                "depth": torch.exp(rd[..., :1]),
                "depth_conf": 1.0 + torch.exp(rd[..., 1]),
                "world_points": torch.sign(xyz) * torch.expm1(xyz.abs()),
                "world_points_conf": 1.0 + torch.exp(rp[..., 3]),
                "tokens": tokens}


def load_crop(path, size: int = 518) -> np.ndarray:
    """VGGT's "crop" preprocessing (vggt/utils/load_fn.py): RGBA over
    white, width to ``size`` and height to the nearest multiple of 14 of
    its scaled value by one bicubic resize, a height past ``size``
    centre-cropped, values in [0, 1]. (3, H, W) float32. PIL and numpy
    only."""
    from PIL import Image
    img = Image.open(path)
    if img.mode == "RGBA":
        bg = Image.new("RGBA", img.size, (255, 255, 255, 255))
        img = Image.alpha_composite(bg, img)
    img = img.convert("RGB")
    w, h = img.size
    nh = round(h * (size / w) / 14) * 14
    arr = np.asarray(img.resize((size, nh), Image.BICUBIC), np.float32)
    if nh > size:
        arr = arr[(nh - size) // 2:(nh - size) // 2 + size]
    return np.ascontiguousarray((arr / 255.0).transpose(2, 0, 1))


def cameras(enc: torch.Tensor, h: int, w: int):
    """Pose encodings (S, 9): t, quaternion (x, y, z, w), FoV (h, w) of an
    OpenCV camera-from-world -> (cam2w (S, 4, 4), K (S, 3, 3)); the
    principal point at the image centre."""
    t, q = enc[:, :3], enc[:, 3:7]
    q = q / q.norm(dim=-1, keepdim=True)
    x, y, z, r = q.unbind(-1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * r),
                     2 * (x * z + y * r)], -1),
        torch.stack([2 * (x * y + z * r), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * r)], -1),
        torch.stack([2 * (x * z - y * r), 2 * (y * z + x * r),
                     1 - 2 * (x * x + y * y)], -1)], -2)
    cam2w = torch.zeros(enc.shape[0], 4, 4, dtype=enc.dtype,
                        device=enc.device)
    cam2w[:, :3, :3] = rot.transpose(1, 2)
    cam2w[:, :3, 3] = -(rot.transpose(1, 2) @ t[:, :, None])[..., 0]
    cam2w[:, 3, 3] = 1.0
    K = torch.zeros(enc.shape[0], 3, 3, dtype=enc.dtype, device=enc.device)
    K[:, 0, 0] = w / 2.0 / torch.tan(enc[:, 8] / 2.0)
    K[:, 1, 1] = h / 2.0 / torch.tan(enc[:, 7] / 2.0)
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = w / 2.0, h / 2.0, 1.0
    return cam2w, K


def unproject(depth, conf, K, cam2w, h: int, w: int, clean: bool = True):
    """Depth (C, H*W) at pixel (u, v) = (column, row) -> world points (C,
    H*W, 3); with ``clean`` a point that lands, in another view, in front
    of what that view sees there (its nearest pixel, by more than 5%) gets
    confidence 1. Returns (points, depth, confidence), one camera at a
    time against all."""
    dev, dt = depth.device, depth.dtype
    c = depth.shape[0]
    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=dt),
                          torch.arange(w, device=dev, dtype=dt),
                          indexing="ij")
    u, v = u.reshape(-1), v.reshape(-1)
    cam = torch.stack([(u - K[:, 0, 2, None]) / K[:, 0, 0, None] * depth,
                       (v - K[:, 1, 2, None]) / K[:, 1, 1, None] * depth,
                       depth], -1)
    world = cam @ cam2w[:, :3, :3].transpose(1, 2) + cam2w[:, None, :3, 3]
    if not clean or c == 1:
        return world, depth, conf
    rot = cam2w[:, :3, :3].transpose(1, 2)            # world -> camera j
    trans = -(rot @ cam2w[:, :3, 3:])[..., 0]
    seen_map = depth.reshape(c, h, w)
    conf = conf.clone()
    for i in range(c):
        bad = torch.zeros(h * w, dtype=torch.bool, device=dev)
        for j in range(c):
            if j == i:
                continue
            pj = world[i] @ rot[j].T + trans[j]
            z = pj[:, 2]
            zc = torch.clamp(z, min=1e-6)
            uj = K[j, 0, 0] * pj[:, 0] / zc + K[j, 0, 2]
            vj = K[j, 1, 1] * pj[:, 1] / zc + K[j, 1, 2]
            inside = (uj >= 0) & (uj < w) & (vj >= 0) & (vj < h) & (z > 1e-6)
            ui = torch.clamp(torch.round(uj).long(), 0, w - 1)
            vi = torch.clamp(torch.round(vj).long(), 0, h - 1)
            bad |= inside & (z < seen_map[j][vi, ui] * 0.95)
        conf[i] = torch.where(bad, torch.ones_like(conf[i]), conf[i])
    return world, depth, conf
