"""Plain PyTorch reference of Fast3R (Yang et al., CVPR 2025,
arXiv:2501.13928; facebookresearch/fast3r, `Fast3R_ViT_Large_512`), written
from the published description in float32: CroCo's ViT encoder on each
view, the fusion transformer over the tokens of all views at once, the
local and global DPT heads, the cameras from their pointmaps, and the
unprojection of depth. It reads weights from a plain dict under the
program's state-dict keys (`layout`) and imports nothing of the program
under test, nor JAX. The CPU tests of the program import this file.

Conventions it follows:
  - the encoder is `reference.network.Net.encode` (pre-LN blocks,
    LayerNorm eps 1e-5, exact GELU, 2D RoPE at base 100 on q and k, the
    head dim split into a y half and an x half, each rotated in
    rotate-half pairs), each view alone;
  - fusion: `decoder_embed`, then view i's 1D sin-cos embedding of index
    i (sin(i w_j), then cos(i w_j), w_j = 10000^(-j / (C / 2))) added to
    each of its tokens, then pre-LN blocks with a biased qkv over all N P
    tokens, RoPE on each token's own patch (y, x), and `dec_norm` on the
    last block's output;
  - heads: DUSt3R's DPT (`reference.network.Net.dpt`) on [encoder output,
    fusion blocks depth/2 and 3 depth/4, the normed last], points
    `exp`-parameterised, confidences 1 + exp(clip(x, -10, 10));
  - cameras (`cameras`): the focal by weighted least squares of
    u - W/2 = f X/Z and v - H/2 = f Y/Z over view 0's global pointmap,
    weighted by its confidence, shared by every view; each view's cam2w
    by Kabsch's SVD of the weighted cross-covariance of its local and
    global points (weights the product of their confidences), the
    determinant's sign corrected;
  - depth is the local points' z, unprojected by
    `reference.vggt.unproject` without the clean-up.

Departures from the published model, each the configuration's `assumed`:
the image-index rule at inference (view i takes index i; Fast3R draws
sorted indices from a wider range in training) and where the embedding is
added (after `decoder_embed`); the cameras by Procrustes, where Fast3R runs
OpenCV's PnP-RANSAC per view on the host; random weights, the fusion
blocks' q and k rows at `QK_GAIN` times the fan-in scale.

``quant``: None computes every matmul and convolution in float32; a
callable is applied to both operands of each matmul of the encoder and the
fusion first, attention's two products included (the control's lower
precision, `reference.precision`); the heads stay float32. The fusion's
attention runs one head and one block of queries at a time: at 64 views
of 512 x 384 a float32 score matrix would be 155 GB a layer.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .network import Net, Quant, fan_in
from .vggt import unproject

__all__ = ("Fast3R", "layout", "fan_in", "index_embedding", "cameras",
           "unproject", "OUT_KEYS", "QK_GAIN")

OUT_KEYS = ("pts_local", "conf_local", "pts_global", "conf_global")
# the fusion blocks' q and k rows of the random weights (`layout`)
QK_GAIN = 2.0
# score-matrix elements one attention call may hold at once
SCORE_BLOCK = 1 << 27
HEADS = ("local", "global")


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every parameter as (key, shape, kind): "weight" (normal, 1/sqrt
    (fan-in)), "qk_weight" (a fusion block's qkv weight: so, with its q
    and k rows times `QK_GAIN`), "bias", "ln_b" and "dead" (zeros:
    refinenet4's first residual unit, which the forward never reads),
    "ln_w" (ones)."""
    e, d, p = cfg["enc_embed_dim"], cfg["dec_embed_dim"], cfg["patch_size"]
    out: List[Tuple[str, Tuple[int, ...], str]] = []

    def lin(name, o, i, kind="weight"):
        out.append((f"{name}.weight", (o, i), kind))
        out.append((f"{name}.bias", (o,), "bias"))

    def conv(name, o, i, k, bias=True, kind="weight"):
        out.append((f"{name}.weight", (o, i, k, k), kind))
        if bias:
            out.append((f"{name}.bias", (o,), "bias" if kind != "dead"
                        else "dead"))

    def ln(name, n):
        out.append((f"{name}.weight", (n,), "ln_w"))
        out.append((f"{name}.bias", (n,), "ln_b"))

    def blocks(stack, depth, c, qkv_kind):
        hid = int(c * cfg["mlp_ratio"])
        for i in range(depth):
            b = f"{stack}.{i}"
            ln(f"{b}.norm1", c)
            lin(f"{b}.attn.qkv", 3 * c, c, qkv_kind)
            lin(f"{b}.attn.proj", c, c)
            ln(f"{b}.norm2", c)
            lin(f"{b}.mlp.fc1", hid, c)
            lin(f"{b}.mlp.fc2", c, hid)

    conv("patch_embed.proj", e, 3, p)
    blocks("enc_blocks", cfg["enc_depth"], e, "weight")
    ln("enc_norm", e)
    lin("decoder_embed", d, e)
    blocks("dec_blocks", cfg["dec_depth"], d, "qk_weight")
    ln("dec_norm", d)
    ld = cfg["dpt_layer_dims"]
    fd, last = cfg["dpt_feature_dim"], cfg["dpt_last_dim"]
    tok = (e, d, d, d)
    for head in HEADS:
        a = f"head_{head}.act_postprocess"
        conv(f"{a}.0.0", ld[0], tok[0], 1)
        conv(f"{a}.0.1", ld[0], ld[0], 4)      # ConvTranspose2d (in, out)
        conv(f"{a}.1.0", ld[1], tok[1], 1)
        conv(f"{a}.1.1", ld[1], ld[1], 2)      # ConvTranspose2d
        conv(f"{a}.2.0", ld[2], tok[2], 1)
        conv(f"{a}.3.0", ld[3], tok[3], 1)
        conv(f"{a}.3.1", ld[3], ld[3], 3)
        s = f"head_{head}.scratch"
        for j in range(1, 5):
            conv(f"{s}.layer{j}_rn", fd, ld[j - 1], 3, bias=False)
            for unit in ("resConfUnit1", "resConfUnit2"):
                kind = "dead" if (j == 4 and unit == "resConfUnit1") \
                    else "weight"
                conv(f"{s}.refinenet{j}.{unit}.conv1", fd, fd, 3, kind=kind)
                conv(f"{s}.refinenet{j}.{unit}.conv2", fd, fd, 3, kind=kind)
            conv(f"{s}.refinenet{j}.out_conv", fd, fd, 1)
        conv(f"head_{head}.head.0", fd // 2, fd, 3)
        conv(f"head_{head}.head.2", last, fd // 2, 3)
        conv(f"head_{head}.head.4", 4, last, 1)
    return out


def index_embedding(n: int, dim: int, device) -> torch.Tensor:
    """(n, dim) float32: the 1D sin-cos embedding of indices 0 .. n - 1."""
    i = np.arange(n, dtype=np.float64)[:, None]
    w = 10000.0 ** (-np.arange(dim // 2, dtype=np.float64) / (dim // 2))
    emb = np.concatenate([np.sin(i * w), np.cos(i * w)], 1)
    return torch.as_tensor(emb, dtype=torch.float32, device=device)


class Fast3R(Net):
    """The reference forward over a weights dict ``w`` (`layout`'s keys)."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: dict,
                 quant: Quant = None):
        super().__init__(w, cfg, quant)
        # the heads: `Net.dpt` in float32, reading head_<x>.* under its
        # own key names (downstream_head_<x>.dpt.*)
        alias = {f"downstream_head_{h}.dpt.{k[len(h) + 6:]}": t
                 for k, t in w.items() for h in HEADS
                 if k.startswith(f"head_{h}.")}
        self.heads = Net(alias, cfg)

    def fusion_attn(self, x, name, heads, pos):
        """Self-attention over all tokens (1, T, C), one head and one
        block of queries at a time."""
        b, t, c = x.shape
        d = c // heads
        qkv = self.linear(x, name + ".qkv").reshape(b, t, 3, heads, d)
        q, k, v = qkv.unbind(2)
        q, k = self.rope(q, pos), self.rope(k, pos)
        rows = max(1, SCORE_BLOCK // (b * t))
        out = torch.empty_like(q)
        for j in range(heads):
            kj, vj = self.q(k[:, :, j]), self.q(v[:, :, j])
            for r0 in range(0, t, rows):
                s = torch.einsum("bqd,bkd->bqk",
                                 self.q(q[:, r0:r0 + rows, j]), kj)
                p = torch.softmax(s / math.sqrt(d), dim=-1)
                out[:, r0:r0 + rows, j] = torch.einsum("bqk,bkd->bqd",
                                                       self.q(p), vj)
        return self.linear(out.reshape(b, t, c), name + ".proj")

    def fuse(self, feats, pos):
        """feats (N, P, enc) -> the hooks' fusion states, each (N, P,
        dec)."""
        cfg = self.cfg
        n, p, _ = feats.shape
        depth, heads = cfg["dec_depth"], cfg["dec_num_heads"]
        x = self.linear(feats, "decoder_embed") + index_embedding(
            n, cfg["dec_embed_dim"], feats.device)[:, None]
        x = x.reshape(1, n * p, -1)
        pos_all = pos.repeat(n, 1)
        hooks = (max(1, depth // 2), max(1, (3 * depth) // 4))
        states = {}
        for i in range(depth):
            b = f"dec_blocks.{i}"
            x = x + self.fusion_attn(self.ln(x, b + ".norm1"), b + ".attn",
                                     heads, pos_all)
            x = x + self.mlp(self.ln(x, b + ".norm2"), b + ".mlp")
            if i + 1 in hooks:
                states[i + 1] = x
        x = self.ln(x, "dec_norm")
        return [s.reshape(n, p, -1) for s in (states[hooks[0]],
                                              states[hooks[1]], x)]

    def forward(self, img, chunk: int = 8) -> Dict[str, torch.Tensor]:
        """img (N, 3, H, W) in [-1, 1] -> pts_local, pts_global (N, H, W,
        3), conf_local, conf_global (N, H, W)."""
        cfg = self.cfg
        n, _, h, w = img.shape
        p = cfg["patch_size"]
        hp, wp = h // p, w // p
        ys, xs = torch.meshgrid(torch.arange(hp, device=img.device),
                                torch.arange(wp, device=img.device),
                                indexing="ij")
        pos = torch.stack([ys.reshape(-1), xs.reshape(-1)], -1)
        feats = torch.cat([self.encode(img[c:c + chunk], pos)
                           for c in range(0, n, chunk)])
        states = [feats] + self.fuse(feats, pos)
        out = {}
        for head in HEADS:
            raw = torch.cat([
                self.heads.dpt([s[c:c + chunk] for s in states], f"_{head}",
                               hp, wp, h, w) for c in range(0, n, chunk)])
            xyz = raw[..., :3]
            dist = torch.linalg.norm(xyz, dim=-1, keepdim=True)
            out[f"pts_{head}"] = xyz / torch.clamp(dist, min=1e-8) \
                * torch.expm1(dist)
            out[f"conf_{head}"] = 1.0 + torch.exp(torch.clamp(
                raw[..., 3], -10.0, 10.0))
        return out


def focal_fit(g0, conf0, dtype=torch.float32) -> float:
    """The least-squares focal of a camera-frame pointmap g0 (H, W, 3)
    weighted by conf0 (H, W), before any clamp and so signed: sum w (u -
    W/2, v - H/2) . (X, Y) / Z over sum w |(X, Y) / Z|^2, Z at least 1e-8
    in magnitude, the sums in ``dtype``."""
    h, w = g0.shape[:2]
    dev = g0.device
    v, u = torch.meshgrid(torch.arange(h, device=dev, dtype=dtype),
                          torch.arange(w, device=dev, dtype=dtype),
                          indexing="ij")
    g0 = g0.to(dtype)
    z = g0[..., 2]
    z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    rx, ry = g0[..., 0] / z, g0[..., 1] / z
    wt = conf0.to(dtype)
    num = (wt * ((u - w / 2.0) * rx + (v - h / 2.0) * ry)).sum()
    den = (wt * (rx * rx + ry * ry)).sum()
    return float(num) / max(float(den), 1e-8)


def cameras(pts_local, conf_local, pts_global, conf_global,
            dtype=torch.float32):
    """(cam2w (N, 4, 4), K (N, 3, 3)) float32 from the pointmaps (N, H, W,
    3) and confidences (N, H, W), the sums in ``dtype`` (the SVD in
    float32 of the covariance so rounded): the focal from view 0's global
    pointmap, then one view at a time its rigid motion from local to
    global points."""
    n, h, w, _ = pts_local.shape
    dev = pts_local.device
    focal = max(focal_fit(pts_global[0], conf_global[0], dtype), 1e-8)
    K = torch.tensor([[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0],
                      [0.0, 0.0, 1.0]], device=dev).repeat(n, 1, 1)
    cam2w = torch.eye(4, device=dev).repeat(n, 1, 1)
    for i in range(n):
        src = pts_local[i].reshape(-1, 3).to(dtype)
        dst = pts_global[i].reshape(-1, 3).to(dtype)
        wi = (conf_local[i] * conf_global[i]).reshape(-1, 1).to(dtype)
        total = wi.sum()
        mu_s = (wi * src).sum(0) / total
        mu_d = (wi * dst).sum(0) / total
        cov = ((wi * (src - mu_s)).T @ (dst - mu_d)).float()
        uu, _, vh = torch.linalg.svd(cov)
        d = torch.sign(torch.linalg.det(vh.T @ uu.T))
        fix = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d),
                                      d if d != 0 else torch.ones_like(d)]))
        rot = vh.T @ fix @ uu.T
        cam2w[i, :3, :3] = rot
        cam2w[i, :3, 3] = mu_d.float() - rot @ mu_s.float()
    return cam2w, K
