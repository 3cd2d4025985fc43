"""The ranks of tests/test_torch_parallel.py: processes of one gloo group on
the CPU, started by `start_world`.

This module imports no JAX: a spawned child imports the module its target
lives in, and tests/conftest.py (which the test module's import would pull
in) pins JAX to eight virtual devices. The parent test writes every input
(a tiny port model's weights, the images, the planted polish problems) to
``inputs.npz`` / ``weights.pt`` in a temporary directory; each rank runs the
jobs named, and writes what the test checks to
``<job>_w<world>_r<rank>.npz`` there. The process group starts from
``file://<dir>/store_w<world>``, so test workers running side by side never
share a TCP port. tests/test_torch_cuda.py runs some of the same jobs on
every card of a machine with several, over NCCL."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# the sharded training runs of the test: 3 steps, n = 512 Gaussians, two
# 32 x 32 cameras (tests/test_distributed.py), and the same with MCMC
# pruning through one refine (step 2) over a pool of 640 slots
GS_N, GS_STEPS, GS_POOL = 8 * 64, 3, 640
# the oracle reconstruction (tests/test_distributed.py): 4 cameras, 64 px
RECON_HW, RECON_N = (64, 64), 4


def gs_inputs():
    """(points, colours, gt, w2c, K) of the sharded-training test, drawn
    from a seed."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(GS_N, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    cols = rng.uniform(size=(GS_N, 3)).astype(np.float32)
    gt = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    w2c = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    K = np.tile(np.array([[30.0, 0, 16], [0, 30.0, 16], [0, 0, 1]],
                         np.float32)[None], (2, 1, 1))
    return pts, cols, gt, w2c, K


def pruning_cfgs():
    """(SplatConfig, MCMCConfig) of the pruning run: a refine at step 2."""
    from starst3r_tpu_torch.config import SplatConfig
    from starst3r_tpu_torch.splat.train import mcmc_config_from
    cfg = SplatConfig()
    mcfg = mcmc_config_from(cfg)._replace(refine_start=2, refine_every=2)
    return cfg, mcfg


def run_pruning(mesh=None, device="cpu"):
    """The pruning run, meshless or sharded: (state, losses)."""
    from starst3r_tpu_torch.splat.train import init_gaussians, run_optim
    pts, cols, gt, w2c, K = gs_inputs()
    cfg, mcfg = pruning_cfgs()
    state = init_gaussians(pts, cols, cfg, seed=5, pool_size=GS_POOL,
                           device=device)
    return run_optim(state, gt, w2c, K, GS_STEPS, cfg, enable_pruning=True,
                     mcfg=mcfg, mesh=mesh)


class OracleModel:
    """The port's copy of tests/test_distributed.py::_OracleModel: exact
    pointmaps and world-point-keyed descriptors of a planted sphere scene
    in place of the network, so the pipeline after inference (matching,
    canonical views, MST, condensation, GA) has a ground truth under a
    mesh. Its inference makes no collective."""

    def __init__(self, poses, K, hw):
        from starst3r_tpu_torch.config import ModelConfig
        self.cfg = ModelConfig.tiny()
        self.device = torch.device("cpu")
        self._tag = "oracle"
        self.poses = poses
        self.K = K
        self.hw = hw
        self._sph_c = np.array([0.0, 0.0, 4.0])
        self._sph_r = 2.8
        rng = np.random.default_rng(7)
        self._W = rng.normal(size=(3, self.cfg.desc_dim)).astype(
            np.float32) * 2.0
        self._b = rng.uniform(0, 2 * np.pi,
                              size=self.cfg.desc_dim).astype(np.float32)

    def _world_pts(self, i):
        h, w = self.hw
        u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                           np.arange(h, dtype=np.float64))
        pix = np.stack([u.ravel(), v.ravel()], -1)
        d_cam = np.stack([(pix[:, 0] - self.K[0, 2]) / self.K[0, 0],
                          (pix[:, 1] - self.K[1, 2]) / self.K[1, 1],
                          np.ones(len(pix))], -1)
        d_w = d_cam @ self.poses[i][:3, :3].T
        oc = self.poses[i][:3, 3] - self._sph_c
        b = (d_w * oc).sum(-1)
        cterm = (oc * oc).sum() - self._sph_r ** 2
        a = (d_w * d_w).sum(-1)
        disc = b * b - a * cterm
        z = (-b - np.sqrt(np.maximum(disc, 1e-12))) / a
        valid = (disc > 0) & (z > 0.1)
        z = np.where(valid, z, 6.0)
        wpts = (d_cam * z[:, None]) @ self.poses[i][:3, :3].T \
            + self.poses[i][:3, 3]
        return (wpts.reshape(h, w, 3).astype(np.float32),
                valid.reshape(h, w))

    def _desc(self, wpts):
        f = np.sin(wpts @ self._W + self._b)
        return (f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True),
                               1e-8)).astype(np.float32)

    def infer_pairs(self, images, pair_indices, batch_size=8,
                    sharding=None):
        from starst3r_tpu_torch.models.mast3r import PairPrediction
        h, w = self.hw
        t = torch.as_tensor
        out = []
        for (i, j) in pair_indices:
            wi, vi = self._world_pts(i)
            wj, vj = self._world_pts(j)
            ci = np.where(vi, 10.0, 0.0).astype(np.float32)
            cj = np.where(vj, 10.0, 0.0).astype(np.float32)
            w2c_i = np.linalg.inv(self.poses[i])

            def in_i(p):
                return (p.reshape(-1, 3) @ w2c_i[:3, :3].T
                        + w2c_i[:3, 3]).reshape(h, w, 3).astype(np.float32)

            out.append(PairPrediction(
                idx1=i, idx2=j, pts1=t(in_i(wi)), conf1=t(ci),
                pts2=t(in_i(wj)), conf2=t(cj), desc1=t(self._desc(wi)),
                desc2=t(self._desc(wj)), desc_conf1=t(ci),
                desc_conf2=t(cj)))
        return out


def recon_config():
    """tests/test_distributed.py's oracle configuration: GA 400 + 30,
    subsample 2."""
    from starst3r_tpu_torch.config import default_config
    cfg = default_config()
    return dataclasses.replace(
        cfg, ga=dataclasses.replace(cfg.ga, niter1=400, niter2=30),
        matching=dataclasses.replace(cfg.matching, subsample=2))


def recon_inputs():
    """(oracle model, images, planted poses)."""
    from starst3r_tpu_torch.utils.synthetic import _look_at_poses
    poses = _look_at_poses(RECON_N).astype(np.float32)
    K = np.array([[90.0, 0, 32.0], [0, 90.0, 32.0], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(-1, 1, size=(3,) + RECON_HW).astype(np.float32)
            for _ in range(RECON_N)]
    return OracleModel(poses, K, RECON_HW), imgs, poses


def tiny_model(tmp, dev):
    """The tiny model with the weights the test wrote, on ``dev``."""
    from starst3r_tpu_torch.config import ModelConfig
    from starst3r_tpu_torch.models.mast3r import Mast3rModel, TwoViewNet
    net = TwoViewNet(ModelConfig.tiny())
    net.load_state_dict(torch.load(os.path.join(tmp, "weights.pt")))
    return Mast3rModel(ModelConfig.tiny(), net, dev)


def _np(t):
    return t.detach().cpu().numpy()


# ---- jobs: job(inputs, tmp, world, device) -> {name: array} a rank writes

def job_optim(inp, tmp, world, dev):
    from starst3r_tpu_torch.config import SplatConfig
    from starst3r_tpu_torch.parallel import make_mesh
    from starst3r_tpu_torch.splat.train import init_gaussians, run_optim
    pts, cols, gt, w2c, K = gs_inputs()
    cfg = SplatConfig()
    mesh = make_mesh()
    s, losses = run_optim(init_gaussians(pts, cols, cfg, device=dev), gt,
                          w2c, K, GS_STEPS, cfg, mesh=mesh)
    sp, losses_p = run_pruning(mesh, dev)
    return {"losses": np.array(losses), "means": _np(s.params["means"]),
            "losses_prune": np.array(losses_p), "n_alive": sp.n_alive,
            **{f"prune_{k}": _np(v) for k, v in sp.params.items()}}


def job_placement(inp, tmp, world, dev):
    from starst3r_tpu_torch.config import SplatConfig
    from starst3r_tpu_torch.parallel import local_mesh, shard_gs_state
    from starst3r_tpu_torch.splat.train import init_gaussians
    mesh = local_mesh()
    rng = np.random.default_rng(int(dist.get_rank()))
    # each rank's copy differs: the shard takes this rank's rows, the
    # scalars and the generator come from rank 0
    pts = np.arange(8 * 16 * 3, dtype=np.float32).reshape(-1, 3)
    cols = rng.uniform(size=(8 * 16, 3)).astype(np.float32)
    st = init_gaussians(pts, cols, SplatConfig(), seed=dist.get_rank(),
                        device=dev)
    st = st._replace(step=7 + dist.get_rank(), n_alive=100 + dist.get_rank())
    sh = shard_gs_state(st, mesh)
    raised = ""
    try:
        shard_gs_state(init_gaussians(pts[:9], cols[:9], SplatConfig(),
                                      device=dev), mesh)
    except ValueError as e:
        raised = str(e)
    return {"means": _np(sh.params["means"]),
            "mu_rows": sh.opt_state.mu["means"].shape[0],
            "step": sh.step, "n_alive": sh.n_alive,
            "gen": sh.generator.get_state().numpy(),
            "lo": sh.shard.lo, "hi": sh.shard.hi, "raised": raised}


def job_infer(inp, tmp, world, dev):
    from starst3r_tpu_torch.parallel import make_mesh, pair_sharding
    model = tiny_model(tmp, dev)
    imgs = list(inp["infer_imgs"])
    pairs = [tuple(p) for p in inp["infer_pairs"]]
    preds = model.infer_pairs(imgs, pairs, batch_size=8,
                              sharding=pair_sharding(make_mesh()))
    return {f: np.stack([_np(getattr(p, f)) for p in preds])
            for f in ("pts1", "desc2", "conf1", "desc_conf2")}


def job_tp(inp, tmp, world, dev):
    from starst3r_tpu_torch.parallel import (make_mesh, pair_sharding,
                                             tp_shard_params)
    mesh = make_mesh(data=world // 2, model=2)
    tp = tp_shard_params(tiny_model(tmp, dev), mesh)
    img1, img2 = inp["tp_img1"], inp["tp_img2"]
    b = img1.shape[0]
    imgs = [im.transpose(2, 0, 1) for im in np.concatenate([img1, img2])]
    preds = tp.infer_pairs(imgs, [(k, b + k) for k in range(b)],
                           batch_size=b,
                           sharding=pair_sharding(mesh, "data"))
    return {f: np.stack([_np(getattr(p, f)) for p in preds])
            for f in ("pts1", "conf2", "desc1", "desc_conf2")}


def job_polish(inp, tmp, world, dev):
    from starst3r_tpu_torch.alignment.lm import lm_refine
    from starst3r_tpu_torch.alignment.schur import Tracks, schur_refine
    from starst3r_tpu_torch.parallel import make_mesh
    mesh = make_mesh()
    out = {}
    lm = [inp[f"lm_{k}"] for k in ("noisy", "focals", "pps", "depths",
                                   "core_pix", "img1", "idx1", "img2",
                                   "idx2", "conf")]
    c2w, f, costs = lm_refine(*lm, iters=3, opt_focal=False, mesh=mesh,
                              device=dev)
    out.update(lm_cam2w=c2w, lm_costs=np.array(costs))
    tracks = Tracks(inp["sc_cam"], inp["sc_pt"], inp["sc_w"])
    sc = [inp[f"sc_{k}"] for k in ("noisy", "focals", "pps", "depths",
                                   "core_pix")]
    c2w, f, costs = schur_refine(*sc, tracks, iters=3, opt_focal=False,
                                 mesh=mesh, device=dev)
    out.update(sc_cam2w=c2w, sc_costs=np.array(costs))
    # no tracks at all: the GA's poses back, costs zero
    empty = Tracks(*(np.zeros((0, 8), dt) for dt in
                     (np.int32, np.int32, np.float32)))
    c2w, f, costs = schur_refine(*sc, empty, iters=2, mesh=mesh,
                                 device=dev)
    out.update(empty_cam2w=c2w, empty_costs=np.array(costs))
    return out


def job_recon(inp, tmp, world, dev):
    """The oracle answers on the CPU: this job runs on the CPU only."""
    from starst3r_tpu_torch.parallel import make_mesh
    from starst3r_tpu_torch.reconstruct import reconstruct_scene
    model, imgs, _ = recon_inputs()
    cache = os.path.join(tmp, f"pairs_w{world}")
    rec, _ = reconstruct_scene(model, imgs, device=dev,
                               config=recon_config(), mesh=make_mesh(),
                               tmpdir=cache)
    pts = np.concatenate(rec.get_dense_pts3d()[0])
    return {"cam2w": rec.cam2w, "K": rec.intrinsics, "pts": pts,
            "cached": len(os.listdir(cache)),
            "leftover": sum(".tmp" in f for f in os.listdir(cache))}


JOBS = {"optim": job_optim, "placement": job_placement, "infer": job_infer,
        "tp": job_tp, "polish": job_polish, "recon": job_recon}


def _rank_main(rank, world, tmp, jobs, device):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from starst3r_tpu_torch.parallel import initialize_distributed
    initialize_distributed(f"file://{tmp}/store_w{world}", world, rank,
                           device=device)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    with np.load(os.path.join(tmp, "inputs.npz")) as f:
        inp = {k: f[k] for k in f.files}
    for job in jobs:
        np.savez(os.path.join(tmp, f"{job}_w{world}_r{rank}.npz"),
                 **JOBS[job](inp, tmp, world, dev))
    dist.destroy_process_group()


def start_world(world: int, tmp: str, jobs, device: str = "cpu"):
    """Start ``jobs`` on ``world`` spawned ranks: a gloo group on the CPU,
    or with ``device`` "cuda" an NCCL group of one rank per card. Returns
    the processes' context for `join_world`."""
    return mp.start_processes(_rank_main,
                              args=(world, tmp, list(jobs), device),
                              nprocs=world, join=False,
                              start_method="spawn")


def join_world(ctx) -> None:
    """Wait for the ranks of `start_world`; raises if one failed."""
    while not ctx.join():
        pass


def result(tmp: str, job: str, world: int, rank: int = 0) -> dict:
    with np.load(os.path.join(tmp, f"{job}_w{world}_r{rank}.npz")) as f:
        return {k: f[k] for k in f.files}
