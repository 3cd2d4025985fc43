"""The yardstick's counts of work: the network's floating-point operations
a pair, and the operations and bytes that front-to-back compositing
needs for given inputs. These count the algorithm, not any kernel's
design: a redesigned kernel is measured against the same work.

Operations per (pixel, Gaussian) pair of compositing, counted from the
arithmetic the algorithm states (gsplat's rasterize_to_pixels):
  - evaluated (the pixel has not stopped when the pair comes up in its
    tile's list): offsets 2, the quadratic form 9, the exp 1, opacity 1,
    the two tests 2: 15;
  - passing (sigma >= 0 and alpha > 1/255): the alpha clip 1, the weight
    1, three colour multiply-adds 6, the transmittance 2: 10;
  - backward, per evaluated pair the forward's 15 again, per passing pair
    the gradient: the transmittance and colour suffix 10, d alpha and
    d sigma 6, the offsets' and conic's terms 17, the colours' 3, the
    opacity's 1, the nine accumulations 9: 46.
A pixel stops after the entry that takes its transmittance below 1e-4.
Bytes: each input row and index read once, each output written once."""

from __future__ import annotations

from typing import Dict

FWD_EVAL_OPS, FWD_PASS_OPS = 15, 10
BWD_EVAL_OPS, BWD_PASS_OPS = 15, 46
STOP_T = 1e-4
ROW_BYTES, INDEX_BYTES, F32 = 36, 4, 4
# float32 operations of one Gaussian's projection into one camera: the
# quaternion's rotation 33, the 3D covariance 45, the camera rotation of
# the mean 18 and of the covariance 90, the Jacobian 10, the 2D covariance
# and its inverse 30, the radius 8, the view direction and the degree-1
# colour 30: 264; its backward twice that.
PROJ_OPS = 264
# SSIM of one image's channel pixel: five separable 11-tap blurs, two
# passes of 11 multiply-adds each, and the map's 18 operations
SSIM_OPS = 5 * 2 * 11 * 2 + 18
# Adam, per parameter element: the moments 6, the bias-corrected step 6
ADAM_OPS = 12
GAUSSIAN_PARAMS = 3 + 3 + 4 + 1 + 3 + 24 * 3   # means ... shN


def network_flops(cfg: dict, h: int, w: int) -> float:
    """Floating-point operations of one pair's forward (both views): 2 per
    multiply-add of every matmul and convolution, and attention's two
    products."""
    p = cfg["patch_size"]
    t = (h // p) * (w // p)
    e, d = cfg["enc_embed_dim"], cfg["dec_embed_dim"]
    me, md = cfg["mlp_ratio"] * e, cfg["mlp_ratio"] * d
    mm = lambda n, k, m: 2.0 * n * k * m
    enc = mm(t, 3 * p * p, e) + cfg["enc_depth"] * (
        mm(t, e, 3 * e) + 2 * mm(t, e, t) + mm(t, e, e) + 2 * mm(t, e, me))
    dec_block = (mm(t, d, 3 * d) + 2 * mm(t, d, t) + mm(t, d, d)     # self
                 + 4 * mm(t, d, d) + 2 * mm(t, d, t)                 # cross
                 + 2 * mm(t, d, md))
    dec = mm(t, e, d) + cfg["dec_depth"] * dec_block
    hp, wp = h // p, w // p
    ld, fd, last = cfg["dpt_layer_dims"], cfg["dpt_feature_dim"], \
        cfg["dpt_last_dim"]
    conv = lambda px, ci, co, k: 2.0 * px * ci * co * k * k
    n = lambda s: (hp * s) * (wp * s)                  # pixels at scale s
    dpt = (conv(n(1), e, ld[0], 1) + 2.0 * n(1) * ld[0] * ld[0] * 16
           + conv(n(1), d, ld[1], 1) + 2.0 * n(1) * ld[1] * ld[1] * 4
           + conv(n(1), d, ld[2], 1)
           + conv(n(1), d, ld[3], 1) + conv(n(0.5), ld[3], ld[3], 3)
           + conv(n(4), ld[0], fd, 3) + conv(n(2), ld[1], fd, 3)
           + conv(n(1), ld[2], fd, 3) + conv(n(0.5), ld[3], fd, 3))
    rcu = lambda s: 2 * conv(n(s), fd, fd, 3)
    dpt += rcu(0.5) + conv(n(1), fd, fd, 1)                  # refinenet4
    dpt += 2 * rcu(1) + conv(n(2), fd, fd, 1)                # refinenet3
    dpt += 2 * rcu(2) + conv(n(4), fd, fd, 1)                # refinenet2
    dpt += 2 * rcu(4) + conv(n(8), fd, fd, 1)                # refinenet1
    dpt += (conv(n(8), fd, fd // 2, 3) + conv(h * w, fd // 2, last, 3)
            + conv(h * w, last, 4, 1))
    idim = e + d
    hid = cfg["desc_hidden_factor"] * idim
    local = mm(t, idim, hid) + mm(t, hid, (cfg["local_feat_dim"] + 1) * p * p)
    return 2 * enc + 2 * dec + 2 * (dpt + local)


def composite_work(packed, gidx, counts, h: int, w: int, tile: int,
                   chunk: int = 128) -> Dict[str, float]:
    """Counts of one compositing call of C cameras: packed (C*N, 9) rows
    [x, y, conic a, b, c, r, g, b, opacity], gidx (C, T, K) each tile's
    rows front to back, counts (C, T). Returns evaluated and passing
    pairs, distinct rows read, list slots, tiles and pixels."""
    import torch
    with torch.no_grad():
        c, t_total, k = gidx.shape
        tw = -(-w // tile)
        dev = packed.device
        pix = torch.arange(tile * tile, device=dev)
        tiles = torch.arange(t_total, device=dev)
        px = ((tiles % tw)[:, None] * tile + pix % tile + 0.5).float()
        py = ((tiles // tw)[:, None] * tile + pix // tile + 0.5).float()
        inside = ((px < w) & (py < h)).float()           # (T, P)
        cnt = counts.reshape(-1).long()
        g = gidx.reshape(c * t_total, k).long()
        pxc, pyc = px.repeat(c, 1), py.repeat(c, 1)
        live_pix = inside.repeat(c, 1)
        trans = torch.ones((c * t_total, tile * tile), device=dev)
        evaluated = passing = 0.0
        for s in range(0, int(cnt.max()) if cnt.numel() else 0, chunk):
            act = torch.nonzero(cnt > s).squeeze(1)
            if act.numel() == 0:
                break
            rows = g[act, s:s + chunk]
            slot = torch.arange(s, s + rows.shape[1], device=dev)
            occupied = slot[None] < cnt[act][:, None]          # (A, B)
            e = packed[rows.clamp(min=0)]                       # (A, B, 9)
            dx = pxc[act][:, None, :] - e[:, :, 0:1]
            dy = pyc[act][:, None, :] - e[:, :, 1:2]
            sigma = 0.5 * (e[:, :, 2:3] * dx * dx + e[:, :, 4:5] * dy * dy) \
                + e[:, :, 3:4] * dx * dy
            alpha = e[:, :, 8:9] * torch.exp(-torch.clamp(sigma, 0.0, 50.0))
            ok = occupied[..., None] & (sigma >= 0) & (alpha > 1.0 / 255.0)
            alpha = torch.where(ok, torch.clamp(alpha, max=0.999),
                                torch.zeros_like(alpha))
            keep = torch.cumprod(1.0 - alpha, 1)
            before = torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]],
                               1) * trans[act][:, None, :]
            running = (before >= STOP_T) & occupied[..., None] \
                & (live_pix[act][:, None, :] > 0)
            evaluated += float(running.sum())
            passing += float((running & ok).sum())
            trans[act] = trans[act] * keep[:, -1]
        valid = (torch.arange(k, device=dev)[None] < cnt[:, None])
        rows = torch.unique(g[valid]).numel()
        return {"evaluated": evaluated, "passing": passing,
                "rows": float(rows), "slots": float(valid.sum()),
                "tiles": float(c * t_total), "pixels": float(c * h * w),
                "table_rows": float(packed.shape[0])}


def composite_fwd_cost(wk: Dict[str, float]):
    ops = FWD_EVAL_OPS * wk["evaluated"] + FWD_PASS_OPS * wk["passing"]
    nbytes = (ROW_BYTES * wk["rows"] + INDEX_BYTES * wk["slots"]
              + INDEX_BYTES * wk["tiles"] + 4 * F32 * wk["pixels"])
    return ops, nbytes


def composite_bwd_cost(wk: Dict[str, float]):
    """In: the rows, lists, the forward's colour and alpha, the pixels'
    gradients; out: the gradient of every table row."""
    ops = BWD_EVAL_OPS * wk["evaluated"] + BWD_PASS_OPS * wk["passing"]
    nbytes = (ROW_BYTES * wk["rows"] + INDEX_BYTES * wk["slots"]
              + INDEX_BYTES * wk["tiles"] + 2 * 4 * F32 * wk["pixels"]
              + ROW_BYTES * wk["table_rows"])
    return ops, nbytes


def least_time(ops: float, nbytes: float, peak_ops: float,
               peak_bytes: float):
    """(seconds, what bounds it)."""
    t_o, t_b = ops / peak_ops, nbytes / peak_bytes
    return max(t_o, t_b), ("operations" if t_o >= t_b else "bytes")
