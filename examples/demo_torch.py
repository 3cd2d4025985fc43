"""End-to-end demo of the PyTorch port (`starst3r_tpu_torch`), the recipe of
`examples/demo.py` on the card unless ``--device cpu``: load images from
disk, a two-call incremental reconstruction, 3DGS init and optimisation,
renders of every view and of a novel interpolated camera path, PNGs and a
scene checkpoint.

Runs with a random-init tiny model by default (no checkpoint needed), so the
geometry is not meaningful: the point is that the whole pipeline runs. Pass
--model <file.npz> (written by either package's `save_pretrained` or by
`convert`) to use trained weights.

Usage:
    python examples/demo_torch.py --imgdir <dir-with-jpg/png> --out demo_out
    python examples/demo_torch.py --synthetic --out demo_out   # no data
"""

import argparse
import os
import sys
import time

# runnable from a checkout without installation
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_synthetic_images(outdir: str, n: int = 4, size: int = 96):
    """Write n synthetic views of a coloured 3D point grid to PNGs."""
    from PIL import Image

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, size=(400, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    cols = (rng.uniform(0.2, 1.0, size=(400, 3)) * 255).astype(np.uint8)
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for k in range(n):
        ang = 0.1 * (k - n / 2)
        R = np.array([[np.cos(ang), 0, np.sin(ang)],
                      [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]], np.float32)
        p = pts @ R.T
        img = np.full((size, size, 3), 30, np.uint8)
        f = size * 0.8
        u = (f * p[:, 0] / p[:, 2] + size / 2).astype(int)
        v = (f * p[:, 1] / p[:, 2] + size / 2).astype(int)
        ok = (u >= 1) & (u < size - 1) & (v >= 1) & (v < size - 1)
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                img[v[ok] + dv, u[ok] + du] = cols[ok]
        path = os.path.join(outdir, f"view_{k}.png")
        Image.fromarray(img).save(path)
        paths.append(path)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--imgdir", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--out", default="starst3r_demo")
    ap.add_argument("--res", type=int, default=96)
    ap.add_argument("--model", default=None, help="checkpoint path (optional)")
    ap.add_argument("--gs-iters", type=int, default=40)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import starst3r_tpu_torch as stt
    from PIL import Image

    dev = stt.utils.resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    if args.synthetic or args.imgdir is None:
        imgdir = os.path.join(args.out, "inputs")
        paths = make_synthetic_images(imgdir, n=4, size=max(96, args.res))
    else:
        paths = sorted(
            os.path.join(args.imgdir, f) for f in os.listdir(args.imgdir)
            if f.lower().endswith((".jpg", ".jpeg", ".png")))
    print(f"[demo] {len(paths)} input images")

    t0 = time.time()
    imgs = stt.load_images(paths, size=args.res)
    print(f"[demo] loaded+processed in {time.time() - t0:.2f}s; "
          f"shape={imgs[0].shape}")

    if args.model:
        model = stt.Mast3rModel.from_pretrained(args.model, device=dev)
    else:
        model = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(),
                                            device=dev)

    scene = stt.Scene(cache_dir=os.path.join(args.out, "cache"), device=dev)

    t0 = time.time()
    scene.add_images(model, imgs[:2])
    print(f"[demo] add_images(first 2): {time.time() - t0:.1f}s, "
          f"{scene.dense_pts_flat.shape[0]} dense pts")
    t0 = time.time()
    scene.add_images(model, imgs[2:])   # incremental warm-start path
    print(f"[demo] add_images(rest): {time.time() - t0:.1f}s, "
          f"{scene.dense_pts_flat.shape[0]} dense pts, "
          f"{len(scene.imgs)} cameras")

    scene.init_3dgs()
    t0 = time.time()
    losses = scene.run_3dgs_optim(args.gs_iters, enable_pruning=True)
    losses += scene.run_3dgs_optim(max(1, args.gs_iters // 4),
                                   enable_pruning=False)
    print(f"[demo] 3DGS optim {len(losses)} iters in {time.time() - t0:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    h, w = scene.imgs[0].shape[:2]
    rendered, _alpha, _info = scene.render_3dgs_original(w, h)
    for i, im in enumerate(rendered.cpu().numpy()):
        Image.fromarray(stt.image_to_uint8(im, mean=0.0, std=1.0)).save(
            os.path.join(args.out, f"render_{i}.png"))

    # novel-view path through interpolated cameras (reference utils.py:57-78)
    c2w_path = stt.interp_se3_path(scene.c2w[0], scene.c2w[-1], steps=5)
    w2c_path = stt.se3_inverse(c2w_path)
    K = np.tile(scene.intrinsics[:1], (5, 1, 1))
    novel, _, _ = scene.render_3dgs(w2c_path, K, w, h)
    for i, im in enumerate(novel.cpu().numpy()):
        Image.fromarray(stt.image_to_uint8(im, mean=0.0, std=1.0)).save(
            os.path.join(args.out, f"novel_{i}.png"))

    ckpt = os.path.join(args.out, "scene.ckpt")
    scene.save(ckpt)
    print(f"[demo] wrote {len(scene.imgs)} renders + 5 novel views + "
          f"checkpoint to {args.out}")
    return scene, losses


if __name__ == "__main__":
    main()
