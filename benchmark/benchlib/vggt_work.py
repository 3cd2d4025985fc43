"""The yardstick's count of VGGT's work: the floating-point operations of
one forward over S views of H x W, 2 per multiply-add of every matmul and
convolution, attention's two products (4 T^2 C an attention of T tokens
of width C) included; norms, activations, softmax and resizes left out.
It counts the algorithm, whatever kernels compute it."""

from __future__ import annotations

from typing import Dict


def _block(t: int, c: int, hidden: int) -> float:
    """A block's linears over t tokens: qkv, proj, the MLP."""
    return 2.0 * t * c * (3 * c + c + 2 * hidden)


def _attention(t: int, c: int) -> float:
    return 4.0 * t * t * c


def vggt_flops(cfg: dict, s: int, h: int, w: int) -> Dict[str, float]:
    """{part: FLOPs} of one forward: ``encoder``, ``frame``, ``global``
    (its linears), ``global_attn``, ``camera``, ``heads``, ``total``."""
    p, c = cfg["patch_size"], cfg["embed_dim"]
    hp, wp = h // p, w // p
    n = hp * wp
    hid = int(c * cfg["mlp_ratio"])
    r = cfg["num_register_tokens"]
    depth = cfg["depth"]
    te, tp = 1 + r + n, 1 + r + n           # DINOv2's tokens, the trunk's
    out = {}
    out["encoder"] = s * (2.0 * n * 3 * p * p * c + cfg["enc_depth"] * (
        _block(te, c, hid) + _attention(te, c)))
    out["frame"] = depth * s * (_block(tp, c, hid) + _attention(tp, c))
    out["global"] = depth * _block(s * tp, c, hid)
    out["global_attn"] = depth * _attention(s * tp, c)
    d = 2 * c
    it = (2.0 * s * 9 * d + 2.0 * s * d * 3 * d
          + cfg["camera_trunk_depth"] * (_block(s, d, 4 * d)
                                         + _attention(s, d))
          + 2.0 * s * d * c + 2.0 * s * c * 9)
    out["camera"] = cfg["camera_iterations"] * it
    out["heads"] = 2 * s * dpt_flops(cfg, hp, wp, h, w)
    out["total"] = sum(out.values())
    return out


def dpt_flops(cfg: dict, hp: int, wp: int, h: int, w: int) -> float:
    """One DPT head on one view: the 1 x 1 projections of the 2 C-wide
    tokens, the resizes (transposed 4x and 2x, a 3 x 3 convolution of
    stride 2), the four 3 x 3 `layer_rn`, the residual units (refinenet4
    one, the others two), each fusion's 1 x 1 at the next level's size,
    the output convolutions."""
    d, f = 2 * cfg["embed_dim"], cfg["dpt_features"]
    oc = cfg["dpt_out_channels"]
    last = cfg["dpt_last_dim"]
    n = hp * wp
    h4, w4 = (hp + 1) // 2, (wp + 1) // 2
    px = [16 * n, 4 * n, n, h4 * w4]        # the four levels' pixels
    conv = lambda pix, ci, co, k: 2.0 * pix * ci * co * k * k
    fl = sum(conv(n, d, o, 1) for o in oc)
    fl += conv(n, oc[0], oc[0], 1) * 16 + conv(n, oc[1], oc[1], 1) * 4
    fl += conv(px[3], oc[3], oc[3], 3)
    fl += sum(conv(px[j], oc[j], f, 3) for j in range(4))
    rcu = lambda pix: 2 * conv(pix, f, f, 3)
    fl += rcu(px[3]) + 2 * (rcu(px[2]) + rcu(px[1]) + rcu(px[0]))
    fl += conv(px[2], f, f, 1) + conv(px[1], f, f, 1) \
        + conv(px[0], f, f, 1) + conv(4 * px[0], f, f, 1)
    fl += conv(4 * px[0], f, f // 2, 3) + conv(h * w, f // 2, last, 3)
    fl += conv(h * w, last, 4, 1)
    return fl
