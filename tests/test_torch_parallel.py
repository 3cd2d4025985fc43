"""The port's `parallel/` on torch.distributed against the JAX package's
meshless results, at world sizes 2 and 4 (gloo on the CPU).

The ranks run in spawned processes (`torch_parallel_workers.py`, which
imports no JAX); every input they need is written here first, and each
rank writes what it computed. Held with the JAX tests' own tolerances
(tests/test_distributed.py, tests/test_lm.py, tests/test_schur.py):

  - `run_optim(mesh=)`, 3 steps, 512 Gaussians, two 32 x 32 cameras, against
    JAX `run_optim`: losses rtol 2e-4, means atol 1e-5 (at world size 4
    two ranks hold no camera); with MCMC pruning through one refine and a
    grown pool, against the port's meshless run;
  - `shard_gs_state`: rank r holds rows [r N/W, (r+1) N/W) of its own copy,
    step, alive count and generator are rank 0's, a pool that does not
    divide raises ValueError as JAX's ``device_put`` does;
  - `infer_pairs(sharding=)` against JAX `infer_pairs`, atol 1e-3;
  - tensor parallelism (model axis 2; data 1 and 2) of `ModelConfig.tiny()`
    against JAX `infer_pair_batch`, atol 2e-3, with at least 20 leaves
    split;
  - `lm_refine` / `schur_refine(mesh=)` against JAX meshless: costs rtol
    1e-3 / 2e-2, poses atol 1e-3; with no track, the start poses back;
  - `reconstruct_scene(mesh=)` on the port's copy of the JAX test's oracle
    model: the planted trajectory recovered (ATE below 0.15 of its scale)
    and within 5e-3 of the meshless run, the same scene on every rank, the
    pair cache written once by rank 0 with no temporary file left;
  - `initialize_distributed` makes a world of one without torchrun's
    variables, and asks for the card by default.

Every rank of every test also returns the same numbers as rank 0.
"""

import os

import numpy as np
import pytest
import torch
import torch_parallel_workers as workers
from torch_threads import one_torch_thread  # noqa: F401

import jax
import jax.numpy as jnp

import starst3r_tpu as st
from starst3r_tpu.alignment import lm as jlm
from starst3r_tpu.alignment import schur as jschur
from starst3r_tpu.config import SplatConfig as JSplatConfig
from starst3r_tpu.io.torch_convert import convert_state_dict as j_convert
from starst3r_tpu.ops.rope import rope_2d_freqs as j_rope_2d_freqs
from starst3r_tpu.splat import train as jtrain

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.config import ModelConfig
from starst3r_tpu_torch.parallel import tp_param_specs
from starst3r_tpu_torch.reconstruct import reconstruct_scene
from starst3r_tpu_torch.utils.eval import ate_rmse

import test_lm
import test_schur

WORLDS = (2, 4)
TINY_HW = (32, 32)
CFG = ModelConfig.tiny()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every job at world sizes 2 and 4, and meanwhile in this process the
    JAX package's meshless results and the port's meshless runs. Returns
    (the directory of the ranks' results, the references).

    The inputs are drawn from seeds: a tiny port model's weights (the JAX
    model gets them through the JAX package's ``.pth`` converter, which
    is quicker than a JAX init), the pair images, the TP batch, and
    tests/test_lm.py's and tests/test_schur.py's instances of their
    sharded tests, each from its own generator seeded 0."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    tmodel = stt.Mast3rModel.init_random(ModelConfig.tiny(), seed=3,
                                         device="cpu")
    sd = tmodel.state_dict()
    torch.save(sd, os.path.join(tmp, "weights.pt"))
    params, unmapped = j_convert(
        {k: v.numpy() for k, v in sd.items()}, CFG.enc_depth,
        CFG.dec_depth, CFG.patch_size, CFG.desc_dim)
    assert unmapped == []
    jmodel = st.Mast3rModel(st.ModelConfig.tiny(), params)
    # the JAX package caches rope's inverse frequencies in an lru_cache
    # (ops/rope.py::_inv_freq); made first inside a jit trace, the cached
    # entry is that trace's tracer and the next trace fails on it.
    # init_random makes them eagerly; a model built from converted weights
    # must too
    for hd in (CFG.enc_dim // CFG.enc_heads, CFG.dec_dim // CFG.dec_heads):
        j_rope_2d_freqs(jnp.zeros((1, 2)), hd, CFG.rope_base)
    rng = np.random.default_rng(0)
    lm = test_lm.synthetic_ba.__wrapped__(rng)
    lm["noisy"] = test_lm._perturb(lm["cam2w"], rng)
    rng = np.random.default_rng(0)
    sc = test_schur._make_seq(rng)
    sc["noisy"] = test_schur._perturb(sc["cam2w"], rng)
    rng = np.random.default_rng(1)
    inp = {
        "infer_imgs": rng.uniform(-1, 1, size=(3, 3) + TINY_HW).astype(
            np.float32),
        "infer_pairs": np.array([(0, 1), (1, 0), (0, 2), (2, 0), (1, 2),
                                 (2, 1)]),
        "tp_img1": rng.uniform(-1, 1, size=(4,) + TINY_HW + (3,)).astype(
            np.float32),
        "tp_img2": rng.uniform(-1, 1, size=(4,) + TINY_HW + (3,)).astype(
            np.float32),
        **{f"lm_{k}": lm[k] for k in ("noisy", "focals", "pps", "depths",
                                       "core_pix", "img1", "idx1", "img2",
                                       "idx2", "conf")},
        **{f"sc_{k}": sc[k] for k in ("noisy", "focals", "pps", "depths",
                                       "core_pix")},
        "sc_cam": sc["tracks"].cam, "sc_pt": sc["tracks"].pt,
        "sc_w": sc["tracks"].w,
    }
    np.savez(os.path.join(tmp, "inputs.npz"), **inp)
    procs = [workers.start_world(w, tmp, workers.JOBS) for w in WORLDS]

    refs = {"sc_noisy": sc["noisy"]}
    pts, cols, gt, w2c, K = workers.gs_inputs()
    cfg = JSplatConfig()
    s, losses = jtrain.run_optim(jtrain.init_gaussians(pts, cols, cfg), gt,
                                 w2c, K, workers.GS_STEPS, cfg)
    refs["gs"] = (np.asarray(losses), np.asarray(s.params["means"]))
    state, losses = workers.run_pruning()
    refs["pruning"] = (state, np.array(losses))
    preds = jmodel.infer_pairs(list(inp["infer_imgs"]),
                               [tuple(p) for p in inp["infer_pairs"]],
                               batch_size=8)
    refs["infer"] = {f: np.stack([np.asarray(getattr(p, f)) for p in preds])
                     for f in ("pts1", "desc2", "conf1", "desc_conf2")}
    refs["batch"] = jax.tree_util.tree_map(np.asarray, jmodel.infer_pair_batch(
        jnp.asarray(inp["tp_img1"]), jnp.asarray(inp["tp_img2"])))
    refs["lm"] = jlm.lm_refine(
        lm["noisy"], lm["focals"], lm["pps"], lm["depths"], lm["core_pix"],
        lm["img1"], lm["idx1"], lm["img2"], lm["idx2"], lm["conf"],
        iters=3, opt_focal=False)
    refs["schur"] = jschur.schur_refine(
        sc["noisy"], sc["focals"], sc["pps"], sc["depths"], sc["core_pix"],
        sc["tracks"], iters=3, opt_focal=False)
    model, imgs, poses = workers.recon_inputs()
    rec, _ = reconstruct_scene(model, imgs, device="cpu",
                               config=workers.recon_config())
    refs["recon"] = (rec, poses)
    for ctx in procs:
        workers.join_world(ctx)
    return tmp, refs


def _all_ranks(tmp, job, world):
    """Rank 0's results, after checking every rank's equal them."""
    first = workers.result(tmp, job, world)
    for r in range(1, world):
        other = workers.result(tmp, job, world, r)
        for k, v in first.items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)
    return first


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_run_optim_matches_jax(runs, world):
    out = _all_ranks(runs[0], "optim", world)
    j_losses, j_means = runs[1]["gs"]
    np.testing.assert_allclose(out["losses"], j_losses, rtol=2e-4)
    np.testing.assert_allclose(out["means"], j_means, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pruning_matches_meshless(runs, world):
    out = _all_ranks(runs[0], "optim", world)
    state, losses = runs[1]["pruning"]
    assert state.n_alive > workers.GS_N          # the refine grew the pool
    assert int(out["n_alive"]) == state.n_alive
    np.testing.assert_allclose(out["losses_prune"], losses, rtol=2e-4)
    for k, v in state.params.items():
        np.testing.assert_allclose(out[f"prune_{k}"], v.numpy(), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_shard_gs_state_placement(runs, world):
    n = 8 * 16
    pts = np.arange(n * 3, dtype=np.float32).reshape(-1, 3)
    gens = []
    for r in range(world):
        out = workers.result(runs[0], "placement", world, r)
        lo, hi = r * n // world, (r + 1) * n // world
        assert (int(out["lo"]), int(out["hi"])) == (lo, hi)
        np.testing.assert_array_equal(out["means"], pts[lo:hi])
        assert int(out["mu_rows"]) == hi - lo
        assert (int(out["step"]), int(out["n_alive"])) == (7, 100)
        assert "divisible by" in str(out["raised"])
        gens.append(out["gen"])
    rank0 = torch.Generator().manual_seed(0).get_state().numpy()
    for g in gens:
        np.testing.assert_array_equal(g, rank0)


@pytest.mark.parametrize("world", WORLDS)
def test_infer_pairs_sharded_matches_jax(runs, world):
    out = _all_ranks(runs[0], "infer", world)
    for k, v in runs[1]["infer"].items():
        np.testing.assert_allclose(out[k], v, atol=1e-3, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_tensor_parallel_inference_matches_jax(runs, world):
    out = _all_ranks(runs[0], "tp", world)
    for k in ("pts1", "conf2", "desc1", "desc_conf2"):
        np.testing.assert_allclose(out[k], runs[1]["batch"][k], atol=2e-3,
                                   err_msg=k)


def test_tp_specs_split_the_transformer():
    from starst3r_tpu_torch.models.mast3r import TwoViewNet
    with torch.device("meta"):
        net = TwoViewNet(ModelConfig.tiny())
    specs = tp_param_specs(net)
    split = {k: s for k, s in specs.items() if "model" in tuple(s)}
    assert len(split) >= 20, len(split)
    assert specs["enc_blocks.0.attn.qkv.weight"] == ("model", None)
    assert specs["enc_blocks.0.attn.qkv.bias"] == ("model",)
    assert specs["enc_blocks.0.attn.proj.weight"] == (None, "model")
    assert specs["enc_blocks.0.attn.proj.bias"] == ()
    assert specs["dec_blocks.1.cross_attn.projk.weight"] == ("model", None)
    assert specs["dec_blocks2.0.mlp.fc2.weight"] == (None, "model")
    assert specs["downstream_head2.head_local_features.fc1.bias"] == (
        "model",)
    assert specs["decoder_embed.weight"] == ()


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lm_refine_matches_jax(runs, world):
    out = _all_ranks(runs[0], "polish", world)
    lm_out, _, lm_costs = runs[1]["lm"]
    np.testing.assert_allclose(out["lm_costs"], lm_costs, rtol=1e-3,
                               atol=1e-9)
    np.testing.assert_allclose(out["lm_cam2w"], lm_out, atol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_schur_refine_matches_jax(runs, world):
    out = _all_ranks(runs[0], "polish", world)
    sc_out, _, sc_costs = runs[1]["schur"]
    np.testing.assert_allclose(out["sc_costs"], sc_costs, rtol=2e-2,
                               atol=1e-8)
    np.testing.assert_allclose(out["sc_cam2w"], sc_out, atol=1e-3)
    # no track at all: nothing to reduce, the start poses and zero costs
    # (the JAX package raises IndexError there; ROADMAP.md queue 3)
    np.testing.assert_allclose(out["empty_cam2w"], runs[1]["sc_noisy"],
                               atol=1e-6)
    assert np.all(out["empty_costs"] == 0.0)


@pytest.mark.parametrize("world", WORLDS)
def test_pair_parallel_reconstruction_oracle(runs, world):
    out = _all_ranks(runs[0], "recon", world)
    rec, poses = runs[1]["recon"]
    traj = float(np.linalg.norm(
        poses[:, :3, 3] - poses[:, :3, 3].mean(0), axis=1).max())
    assert float(ate_rmse(rec.cam2w, poses)) / traj < 0.15
    assert float(ate_rmse(out["cam2w"], poses)) / traj < 0.15
    np.testing.assert_allclose(out["cam2w"], rec.cam2w, atol=5e-3)
    n = workers.RECON_N
    assert int(out["cached"]) == n * (n - 1)
    assert int(out["leftover"]) == 0


def test_initialize_distributed_world_of_one(monkeypatch):
    import torch.distributed as dist
    from starst3r_tpu_torch.parallel import (initialize_distributed,
                                             local_mesh, make_mesh)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            initialize_distributed()
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()
    initialize_distributed(device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        initialize_distributed(device="cpu")          # a no-op now
        with pytest.raises(RuntimeError, match="gloo"):
            initialize_distributed(device="cpu", backend="nccl")
        mesh = make_mesh()
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert tuple(local_mesh().shape) == (1,)
    finally:
        dist.destroy_process_group()
