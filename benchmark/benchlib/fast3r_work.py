"""The yardstick's count of Fast3R's work: the floating-point operations of
one forward over N views of H x W, 2 per multiply-add of every matmul and
convolution, attention's two products (4 T^2 C an attention of T tokens
of width C) included; norms, activations, softmax, resizes and the
cameras left out. It counts the algorithm, whatever kernels compute it.
The fusion's q and k rotation is counted in bytes (`rotate_bytes`): it is
bound by memory."""

from __future__ import annotations

from typing import Dict


def _linears(t: int, c: int, hidden: int) -> float:
    """A block's linears over t tokens: qkv, proj, the MLP."""
    return 2.0 * t * c * (3 * c + c + 2 * hidden)


def _attention(t: int, c: int) -> float:
    return 4.0 * t * t * c


def fast3r_flops(cfg: dict, n: int, h: int, w: int) -> Dict[str, float]:
    """{part: FLOPs} of one forward: ``encoder`` (its attention included),
    ``fuse`` (the fusion's linears and ``decoder_embed``), ``fuse_attn``,
    ``heads`` (both DPT heads), ``total``."""
    p = cfg["patch_size"]
    hp, wp = h // p, w // p
    t = hp * wp
    e, d = cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    out = {}
    out["encoder"] = n * (2.0 * t * 3 * p * p * e + cfg["enc_depth"] * (
        _linears(t, e, int(e * cfg["mlp_ratio"])) + _attention(t, e)))
    out["fuse"] = 2.0 * n * t * e * d + cfg["dec_depth"] * _linears(
        n * t, d, int(d * cfg["mlp_ratio"]))
    out["fuse_attn"] = cfg["dec_depth"] * _attention(n * t, d)
    out["heads"] = 2 * n * dpt_flops(cfg, hp, wp, h, w)
    out["total"] = sum(out.values())
    return out


def dpt_flops(cfg: dict, hp: int, wp: int, h: int, w: int) -> float:
    """One DUSt3R DPT head on one view (the pair count of
    `benchlib.work.network_flops`' DPT, per view): the 1 x 1 projections,
    the resizes (transposed 4x and 2x, a 3 x 3 convolution of stride 2),
    the four 3 x 3 `layer_rn`, the residual units (refinenet4 one, the
    others two), each fusion's 1 x 1 at twice its grid, the output
    convolutions."""
    e, d = cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    ld, fd, last = cfg["dpt_layer_dims"], cfg["dpt_feature_dim"], \
        cfg["dpt_last_dim"]
    conv = lambda px, ci, co, k: 2.0 * px * ci * co * k * k
    n = lambda s: (hp * s) * (wp * s)                  # pixels at scale s
    fl = (conv(n(1), e, ld[0], 1) + 2.0 * n(1) * ld[0] * ld[0] * 16
          + conv(n(1), d, ld[1], 1) + 2.0 * n(1) * ld[1] * ld[1] * 4
          + conv(n(1), d, ld[2], 1)
          + conv(n(1), d, ld[3], 1) + conv(n(0.5), ld[3], ld[3], 3)
          + conv(n(4), ld[0], fd, 3) + conv(n(2), ld[1], fd, 3)
          + conv(n(1), ld[2], fd, 3) + conv(n(0.5), ld[3], fd, 3))
    rcu = lambda s: 2 * conv(n(s), fd, fd, 3)
    fl += rcu(0.5) + conv(n(1), fd, fd, 1)                  # refinenet4
    fl += 2 * rcu(1) + conv(n(2), fd, fd, 1)                # refinenet3
    fl += 2 * rcu(2) + conv(n(4), fd, fd, 1)                # refinenet2
    fl += 2 * rcu(4) + conv(n(8), fd, fd, 1)                # refinenet1
    fl += (conv(n(8), fd, fd // 2, 3) + conv(h * w, fd // 2, last, 3)
           + conv(h * w, last, 4, 1))
    return fl


def rotate_bytes(cfg: dict, n: int, h: int, w: int) -> float:
    """Bytes one forward's q and k rotation must move: each fusion call
    reads q and k (bfloat16) and the cos and sin tables (float32, one row
    a token) once and writes the rotated q and k once."""
    p = cfg["patch_size"]
    t = n * (h // p) * (w // p)
    d = cfg["dec_embed_dim"]
    head = d // cfg["dec_num_heads"]
    per_call = 2 * (2 * t * d * 2) + 2 * t * head * 4
    return cfg["dec_depth"] * float(per_call)
