"""Command-line interface of the PyTorch port (port of
`starst3r_tpu/cli.py`): ``python -m starst3r_tpu_torch <cmd>`` or
``starst3r-torch <cmd>``.

  reconstruct   images dir -> poses + dense point cloud (+ optional 3DGS)
  train-gs      continue 3DGS optimisation from a scene checkpoint
  render-path   render an interpolated novel-view camera path
  export-ply    dump the Gaussian means to PLY
  convert       public MASt3R .pth weights -> .npz
  info          versions, devices and the default device

Subcommands, flags, defaults and outputs are the JAX package's: everything
goes into an --out directory (scene.ckpt, points.ply, c2w.npy,
intrinsics.npy, metrics.jsonl, frame_*.png), in the JAX package's file
formats, so either package reads the other's. Two points differ: the
top-level ``--device`` (default ``cuda``; without a GPU a command that
computes raises as `utils.device.resolve_device` does unless it is given
``--device cpu``), and there is no ``bench`` subcommand.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

__all__ = ("main",)


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="starst3r-torch", description="3D reconstruction + novel-view "
        "synthesis on PyTorch and CUDA (Starst3r-compatible pipeline)")
    ap.add_argument("--trace-dir", default=None,
                    help="write torch.profiler traces for each pipeline "
                    "phase into this directory (TensorBoard format); "
                    "equivalent to setting STARST3R_TRACE_DIR")
    ap.add_argument("--device", default="cuda",
                    help="the device the commands compute on: cuda (the "
                    "default) or cpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rec = sub.add_parser("reconstruct", help="images -> poses + point cloud")
    rec.add_argument("--imgdir", required=True)
    rec.add_argument("--out", required=True)
    rec.add_argument("--res", type=int, default=None,
                     help="longest-edge resolution (reference default 224; "
                     "512 with a Fast3R preset); with a VGGT preset the "
                     "width (default 518)")
    rec.add_argument("--preset", default="tiny",
                     choices=["tiny", "small", "base", "large", "vggt_1b",
                              "vggt_tiny", "fast3r_vitl_512", "fast3r_tiny"],
                     help="the network: MASt3R's presets, or VGGT-1B "
                     "(vggt_1b; vggt_tiny for the CPU) or Fast3R ViT-L/512 "
                     "(fast3r_vitl_512; fast3r_tiny for the CPU), which reconstruct all images in one forward "
                     "with no pairs and no global alignment (the --ga-*, "
                     "--pair-graph, --refine-* and depth flags do not "
                     "apply)")
    rec.add_argument("--model", default=None,
                     help="model checkpoint path (overrides --preset weights)")
    rec.add_argument("--pair-graph", default="complete",
                     choices=["complete", "sliding"])
    rec.add_argument("--window", type=int, default=3,
                     help="sliding-window half width")
    rec.add_argument("--conf-thres", type=float, default=1.5)
    rec.add_argument("--ga-iters1", type=int, default=None)
    rec.add_argument("--ga-iters2", type=int, default=None)
    rec.add_argument("--gs-iters", type=int, default=0,
                     help="if >0, run 3DGS for this many iterations")
    rec.add_argument("--incremental-batch", type=int, default=0,
                     help="feed images in batches of this size through "
                     "add_images (exercises the SLAM warm-start path); "
                     "0 = all at once")
    rec.add_argument("--refine-lm", action="store_true",
                     help="polish the GA poses with Levenberg-Marquardt "
                     "over absolute poses (+focal)")
    rec.add_argument("--lm-iters", type=int, default=12)
    rec.add_argument("--refine-mode", default="lm", choices=["lm", "schur"],
                     help="lm = dense two-view normal equations; schur = "
                     "latent-track Schur-complement reduction (keyframe "
                     "scale path)")
    rec.add_argument("--shared-intrinsics", action="store_true",
                     help="optimize one focal + principal point shared by "
                     "all cameras (reference reconstruct.py:67)")
    rec.add_argument("--exp-depth", action="store_true",
                     help="parameterize core depth in log space "
                     "(positivity by construction; reference "
                     "reconstruct.py:122,249-250)")
    rec.add_argument("--lora-depth", action="store_true",
                     help="optimize per-image depth as k spectral "
                     "coefficients over an image-appearance Laplacian "
                     "basis (reference reconstruct.py:123,270-273); "
                     "implies --opt-depth")
    rec.add_argument("--lora-k", type=int, default=96)
    rec.add_argument("--opt-depth", action="store_true",
                     help="make per-image depth trainable in the fine GA "
                     "phase (reference opt_depth, reconstruct.py:66)")

    tgs = sub.add_parser("train-gs", help="continue 3DGS from a checkpoint")
    tgs.add_argument("--scene", required=True, help="scene.ckpt path")
    tgs.add_argument("--out", default=None,
                     help="output dir (default: alongside the ckpt)")
    tgs.add_argument("--iters", type=int, default=400)
    tgs.add_argument("--no-pruning", action="store_true")
    tgs.add_argument("--ssim-fac", type=float, default=0.2)
    tgs.add_argument("--opacity-fac", type=float, default=0.01)
    tgs.add_argument("--scale-fac", type=float, default=0.01)

    ren = sub.add_parser("render-path",
                         help="render an interpolated camera path")
    ren.add_argument("--scene", required=True)
    ren.add_argument("--out", required=True)
    ren.add_argument("--steps", type=int, default=30)
    ren.add_argument("--width", type=int, default=0,
                     help="0 = native image width")
    ren.add_argument("--height", type=int, default=0)
    ren.add_argument("--cameras", default=None,
                     help="comma-separated camera indices for the key poses "
                     "(default: all, in order)")

    ply = sub.add_parser("export-ply", help="dump points to a PLY file")
    ply.add_argument("--scene", required=True)
    ply.add_argument("--out", required=True, help="output .ply path")
    ply.add_argument("--source", default="gaussians",
                     choices=["gaussians"],
                     help="which point set to export")

    cvt = sub.add_parser("convert",
                         help="convert public MASt3R .pth weights to .npz")
    cvt.add_argument("--pth", required=True, help="torch checkpoint path")
    cvt.add_argument("--out", required=True, help="output .npz path")
    cvt.add_argument("--preset", default="large",
                     choices=["tiny", "small", "base", "large"])

    sub.add_parser("info", help="print versions / devices / defaults")
    return ap


def _load_scene_module():
    # deferred heavy imports so `--help` stays fast
    import starst3r_tpu_torch as stt
    return stt


def _image_paths(imgdir: str) -> List[str]:
    return sorted(
        os.path.join(imgdir, f) for f in os.listdir(imgdir)
        if f.lower().endswith((".jpg", ".jpeg", ".png")))


def _cmd_reconstruct(args, device) -> int:
    stt = _load_scene_module()
    from .imaging import image_route
    from .io.ply import save_ply
    from .utils.metrics import MetricsLogger

    os.makedirs(args.out, exist_ok=True)
    logger = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))

    paths = _image_paths(args.imgdir)
    if len(paths) < 2:
        print(f"error: need >= 2 images in {args.imgdir}", file=sys.stderr)
        return 2
    vggt = args.preset.startswith("vggt")
    fast3r = args.preset.startswith("fast3r")
    if vggt:
        route = "pil"
        imgs = stt.load_images(paths, size=args.res or 518, mode="crop")
    else:
        route = image_route()
        res = args.res or (512 if fast3r else 224)
        imgs = stt.load_images(paths, size=res, impl=route)
    logger.log("load_images", impl=route, n_images=len(imgs),
               shape=list(imgs[0].shape))

    cfg = stt.default_config()
    cfg = dataclasses.replace(cfg, model=stt.model_preset(args.preset))
    ga = dataclasses.replace(
        cfg.ga,
        niter1=args.ga_iters1 if args.ga_iters1 is not None
        else cfg.ga.niter1,
        niter2=args.ga_iters2 if args.ga_iters2 is not None
        else cfg.ga.niter2,
        refine_lm=bool(args.refine_lm),
        lm_iters=args.lm_iters,
        lm_mode=args.refine_mode,
        shared_intrinsics=bool(args.shared_intrinsics),
        exp_depth=bool(args.exp_depth),
        lora_depth=bool(args.lora_depth),
        lora_k=args.lora_k,
        # lora_depth without opt_depth would freeze the coefficients and
        # merely replace the init depth with a lossy rank-k approximation
        opt_depth=bool(args.opt_depth or args.lora_depth))
    cfg = dataclasses.replace(cfg, ga=ga)

    if vggt or fast3r:
        if args.model:
            print("error: --model loads MASt3R checkpoints; a VGGT or "
                  "Fast3R preset runs on random weights", file=sys.stderr)
            return 2
        cls = stt.VGGTModel if vggt else stt.Fast3RModel
        model = cls.init_random(cfg.model, device=device)
    elif args.model:
        model = stt.Mast3rModel.from_pretrained(args.model, device=device)
    else:
        model = stt.Mast3rModel.init_random(cfg.model, device=device)

    scene = stt.Scene(cache_dir=os.path.join(args.out, "cache"),
                      device=device, config=cfg, logger=logger)
    batch = args.incremental_batch or len(imgs)
    for s in range(0, len(imgs), batch):
        scene.add_images(model, imgs[s:s + batch],
                         conf_thres=args.conf_thres,
                         pair_graph=args.pair_graph)
        print(f"[reconstruct] {len(scene.imgs)} cameras, "
              f"{scene.dense_pts_flat.shape[0]} dense points")

    if args.gs_iters > 0:
        scene.init_3dgs()
        losses = scene.run_3dgs_optim(args.gs_iters, enable_pruning=True)
        print(f"[reconstruct] 3DGS {args.gs_iters} iters, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    ckpt = os.path.join(args.out, "scene.ckpt")
    scene.save(ckpt)
    save_ply(os.path.join(args.out, "points.ply"), scene.dense_pts_flat,
             scene.dense_cols_flat)
    np.save(os.path.join(args.out, "c2w.npy"), scene.c2w)
    np.save(os.path.join(args.out, "intrinsics.npy"), scene.intrinsics)
    print(f"[reconstruct] wrote {ckpt} + points.ply "
          f"({scene.dense_pts_flat.shape[0]} pts; images loaded through "
          f"the {route} route)")
    return 0


def _load_splat_scene(args, device):
    """The scene of ``--scene``, or None (after saying why) when it holds
    no Gaussians."""
    stt = _load_scene_module()
    scene = stt.Scene.load(args.scene, device=device)
    if scene.gs_state is None:
        print("error: no Gaussians in checkpoint (run reconstruct with "
              "--gs-iters first)", file=sys.stderr)
        return None
    return scene


def _cmd_train_gs(args, device) -> int:
    scene = _load_splat_scene(args, device)
    if scene is None:
        return 2
    losses = scene.run_3dgs_optim(
        args.iters, enable_pruning=not args.no_pruning,
        loss_ssim_fac=args.ssim_fac, loss_opacity_fac=args.opacity_fac,
        loss_scale_fac=args.scale_fac)
    out = args.out or os.path.dirname(os.path.abspath(args.scene))
    os.makedirs(out, exist_ok=True)
    scene.save(os.path.join(out, "scene.ckpt"))
    print(f"[train-gs] {args.iters} iters, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; saved {os.path.join(out, 'scene.ckpt')}")
    return 0


def camera_path(c2w: np.ndarray, cameras: Optional[Sequence[int]],
                steps: int) -> np.ndarray:
    """The render-path camera path: segments of `interp_se3_path` through
    the key poses ``c2w[cameras]`` (all cameras, in order, by default),
    each segment's duplicated first frame dropped. Returns (F, 4, 4)
    camera-to-world float32."""
    from .utils.se3 import interp_se3_path

    idxs = list(range(len(c2w))) if cameras is None else list(cameras)
    keys = np.asarray(c2w)[idxs]
    if len(keys) < 2:
        keys = np.concatenate([keys, keys], axis=0)
    nseg = max(1, len(keys) - 1)
    per_seg = max(2, -(-(steps - 1) // nseg) + 1)
    path_mats: List[np.ndarray] = []
    for a, b in zip(keys[:-1], keys[1:]):
        seg = interp_se3_path(a, b, steps=per_seg).numpy()
        # segment boundaries coincide: drop the duplicated first frame
        path_mats.append(seg if not path_mats else seg[1:])
    return np.concatenate(path_mats, axis=0)


def _cmd_render_path(args, device) -> int:
    import torch
    from PIL import Image

    from .imaging import image_to_uint8
    from .utils.se3 import se3_inverse

    scene = _load_splat_scene(args, device)
    if scene is None:
        return 2
    os.makedirs(args.out, exist_ok=True)
    cameras = (None if args.cameras is None
               else [int(x) for x in args.cameras.split(",")])
    c2w_path = camera_path(scene.c2w, cameras, args.steps)
    w2c_path = se3_inverse(torch.from_numpy(c2w_path)).numpy()

    h, w = (scene.imgs[0].shape[:2] if scene.imgs else (224, 224))
    w = args.width or w
    h = args.height or h
    K = np.tile(scene.intrinsics[:1], (len(w2c_path), 1, 1))
    rgb, _, _ = scene.render_3dgs(w2c_path, K, w, h)
    for i, im in enumerate(rgb.cpu().numpy()):
        Image.fromarray(image_to_uint8(im, mean=0.0, std=1.0)).save(
            os.path.join(args.out, f"frame_{i:04d}.png"))
    print(f"[render-path] wrote {len(w2c_path)} frames to {args.out}")
    return 0


def dc_colors(sh0: np.ndarray, compat_inverted_sh: bool) -> np.ndarray:
    """The DC colour in [0, 1] back from the SH DC term (N, 3): the compat
    inverted-SH init stores 1 - colour, the standard one
    (colour - 0.5) / C0."""
    if compat_inverted_sh:
        return np.clip(1.0 - sh0, 0, 1)
    return np.clip(sh0 * 0.28209479177387814 + 0.5, 0, 1)


def _cmd_export_ply(args, device) -> int:
    from .io.ply import save_ply

    scene = _load_splat_scene(args, device)
    if scene is None:
        return 2
    means = scene.gs_state.params["means"].cpu().numpy()
    sh0 = scene.gs_state.params["sh0"][:, 0].cpu().numpy()
    cols = dc_colors(sh0, scene.config.splat.compat_inverted_sh)
    save_ply(args.out, means, cols)
    print(f"[export-ply] wrote {means.shape[0]} points to {args.out}")
    return 0


def _cmd_convert(args, device) -> int:
    from .io.torch_convert import convert_file
    convert_file(args.pth, args.out, preset=args.preset, device=device)
    print(f"[convert] wrote {args.out}")
    return 0


def _cmd_info(args) -> int:
    import torch

    from .version import __version__
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    print(json.dumps({
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "devices": ["cpu"] + [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                              for i in range(n)],
        "default_device": args.device,
    }, indent=2))
    return 0


_DISPATCH = {
    "reconstruct": _cmd_reconstruct,
    "train-gs": _cmd_train_gs,
    "render-path": _cmd_render_path,
    "export-ply": _cmd_export_ply,
    "convert": _cmd_convert,
}


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.trace_dir:
        os.environ["STARST3R_TRACE_DIR"] = args.trace_dir
    if args.cmd == "info":
        return _cmd_info(args)
    from .utils.device import resolve_device
    return _DISPATCH[args.cmd](args, resolve_device(args.device))


if __name__ == "__main__":
    raise SystemExit(main())
