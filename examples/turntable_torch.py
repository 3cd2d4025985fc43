"""Render a novel-view turntable GIF from a full reconstruct -> splat run on
the PyTorch port (`starst3r_tpu_torch`): the recipe of
`examples/turntable.py`, on the card unless ``--device cpu``.

Pipeline (no checkpoint needed): a synthetic textured-sphere scene with
exact correspondences (8 cameras) -> the sparse global alignment recovers
the camera trajectory (500 + 200 steps) -> 3DGS trains on the RECOVERED
poses (confidence-masked seeding, per-point scales, per-parameter learning
rates) -> an SE(3)-interpolated orbit (utils.se3.interp_se3_path) ->
frames -> an animated GIF and its middle frame as a PNG. It prints the GA's
and the training's seconds, the loss, and the PSNR of the trained splats
rendered at the recovered poses against the input views.

Usage:
    python examples/turntable_torch.py --out turntable.gif [--iters 600]
    python examples/turntable_torch.py --quick   # 64 px, 150 iters, 16 frames
    python examples/turntable_torch.py --quick --device cpu
"""

import argparse
import os
import sys
import time

# runnable from a checkout without installation
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def turntable(hw=128, iters=600, frames=48, device="cuda"):
    """Run the recipe. Returns a dict: the planted scene (``data``,
    ``gt_c2w``, ``images`` (8, hw, hw, 3) in [0, 1]), the GA's result
    ``ga`` (recovered ``cam2w``, ``w2c``, ``K`` ...), the trained ``state``,
    the ``losses``, the training views' ``psnr`` at the recovered poses,
    the orbit's ``frames`` (uint8 (F, hw, hw, 3)), and the seconds of the GA
    (``ga_s``) and of training (``gs_s``) on the host clock, each ending in
    a read of its result."""
    import torch

    from starst3r_tpu_torch.alignment.ga import run_global_alignment
    from starst3r_tpu_torch.config import GAConfig, SplatConfig
    from starst3r_tpu_torch.ops.ssim import psnr
    from starst3r_tpu_torch.splat.train import (init_gaussians, render,
                                                run_optim)
    from starst3r_tpu_torch.utils.device import resolve_device
    from starst3r_tpu_torch.utils.se3 import interp_se3_path, se3_inverse
    from starst3r_tpu_torch.utils.synthetic import synthetic_image_scene

    dev = resolve_device(device)
    sub = 2 if hw >= 128 else 4
    data, mst, gt, _K, imgs, hit = synthetic_image_scene(
        n_cams=8, hw=hw, subsample=sub, spread=0.25, focal=180.0 * hw / 128)
    t0 = time.perf_counter()
    res, _ = run_global_alignment(
        data, mst, GAConfig(niter1=500, niter2=200, lr2=0.004), device=dev)
    cam2w = res.cam2w.cpu().numpy()
    ga_s = time.perf_counter() - t0

    cp = np.asarray(data.core_pix).astype(np.int64)
    m = hit.reshape(-1)
    pts = res.pts3d.cpu().numpy().reshape(-1, 3)[m]
    cols = np.stack([imgs[i][cp[:, 1], cp[:, 0]]
                     for i in range(8)]).reshape(-1, 3)[m]
    K = res.K.cpu().numpy()
    scales = (res.depth.cpu().numpy().reshape(-1)[m] * sub
              / K[:, 0, 0].repeat(cp.shape[0])[m])
    cfg = SplatConfig(
        rebin_every=4, compat_inverted_sh=False,
        compat_raw_activations=False, lr_means=3e-5, lr_quats=1e-3,
        lr_scales=5e-3, lr_opacities=5e-2, lr_sh=2.5e-3,
        loss_anchor_fac=0.3, mcmc_refine_start=300, mcmc_refine_stop=550)
    state = init_gaussians(pts, cols, cfg, point_scales=scales,
                           pool_size=int(2.0 * pts.shape[0]), device=dev)
    w2c = res.w2c.cpu().numpy()
    t1 = time.perf_counter()
    state, losses = run_optim(state, imgs, w2c, K, iters, cfg,
                              enable_pruning=True)
    gs_s = time.perf_counter() - t1

    with torch.no_grad():
        rgb, _, _ = render(state.params, w2c, K, hw, hw, cfg,
                           n_alive=state.n_alive)
        train_psnr = float(psnr(rgb, torch.as_tensor(imgs, device=dev)))

    # orbit: ping-pong through the recovered key poses and back, so the
    # GIF loops smoothly
    keys = np.concatenate([cam2w, cam2w[-2::-1]], axis=0)
    nseg = len(keys) - 1
    per_seg = max(2, frames // nseg + 1)
    mats = []
    for a, b in zip(keys[:-1], keys[1:]):
        seg = interp_se3_path(a, b, steps=per_seg).numpy()
        mats.append(seg if not mats else seg[1:])
    w2c_path = se3_inverse(torch.from_numpy(np.concatenate(mats))).numpy()
    Kp = np.tile(K[:1], (len(w2c_path), 1, 1))
    with torch.no_grad():
        orbit, _, _ = render(state.params, w2c_path, Kp, hw, hw, cfg,
                             n_alive=state.n_alive)
    orbit = (np.clip(orbit.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    return dict(data=data, gt_c2w=gt, images=imgs, ga=res, state=state,
                losses=losses, psnr=train_psnr, frames=orbit, ga_s=ga_s,
                gs_s=gs_s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="turntable.gif")
    ap.add_argument("--iters", type=int, default=600)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--quick", action="store_true",
                    help="64px / 150 iters / 16 frames (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.quick:
        args.hw, args.iters, args.frames = 64, 150, 16

    from PIL import Image

    out = turntable(args.hw, args.iters, args.frames, args.device)
    losses = out["losses"]
    print(f"[turntable] GA recovered 8 poses in {out['ga_s']:.1f}s")
    print(f"[turntable] 3DGS {args.iters} iters in {out['gs_s']:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; training-view PSNR "
          f"{out['psnr']:.2f} dB")
    frames = [Image.fromarray(f) for f in out["frames"]]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    frames[0].save(args.out, save_all=True, append_images=frames[1:],
                   duration=80, loop=0)
    frames[len(frames) // 2].save(os.path.splitext(args.out)[0] + ".png")
    print(f"[turntable] wrote {len(frames)}-frame GIF to {args.out}")
    return out


if __name__ == "__main__":
    main()
