"""Runs of tiny cells on the CPU with the timed path broken underneath:
each fault a cell can have must make ``correct`` false. (One chip: no
cell has an exchange between chips to leave out.)"""

import pytest
import torch

import bench_tiny


def _checks(result):
    return {k: v["value"] for k, v in result["checks"].items()}


def _recon(**kw):
    return bench_tiny.run_tiny("recon", seconds=0.5, **kw)


def test_recon_alignment_that_keeps_its_state(monkeypatch):
    """Each phase returns its start and reports no loss of it."""
    from starst3r_tpu_torch.alignment import ga
    monkeypatch.setattr(ga, "_optimize_phase",
                        lambda params, *a, **k: (params, float("nan")))
    r = _recon()
    assert not r["correct"], r["checks"]


def plant_still_alignment(mp):
    """Each alignment phase runs every step at a learning rate of 0: it
    returns its start and honestly reports the start's loss."""
    from starst3r_tpu_torch.alignment import ga
    real = ga._optimize_phase

    def still(params, state, niter, lr_base, lr_end, *a, **k):
        return real(params, state, niter, 0.0, 0.0, *a, **k)

    still.__dict__.update(real.__dict__)   # the phase's counters
    mp.setattr(ga, "_optimize_phase", still)


def plant_black_tile(mp, tile: int = 16):
    """The tile at the centre of each rendered image comes out black."""
    from starst3r_tpu_torch.splat import train
    real = train.render

    def altered(*a, **k):
        rgb, alpha, info = real(*a, **k)
        y, x = (rgb.shape[1] // 2 // tile * tile,
                rgb.shape[2] // 2 // tile * tile)
        rgb = rgb.clone()
        rgb[:, y:y + tile, x:x + tile] = 0.0
        return rgb, alpha, info

    mp.setattr(train, "render", altered)


# the faults that the control script can also plant on the card
PLANTS = {"still_alignment": plant_still_alignment,
          "black_tile": plant_black_tile}


def test_recon_alignment_that_keeps_its_start_and_its_loss(monkeypatch):
    plant_still_alignment(monkeypatch)
    r = _recon()
    c = _checks(r)
    assert not r["correct"] and c["ga_still"] > 1e3, r["checks"]
    assert c["ga_loss_gap"] <= r["checks"]["ga_loss_gap"]["limit"]


def test_recon_half_of_each_batch_left_out(monkeypatch):
    """The network runs the first half of each batch and gives its mean
    output to the rest."""
    from starst3r_tpu_torch.models.mast3r import Mast3rModel
    real = Mast3rModel.infer_pair_batch

    def half(self, img1, img2):
        k = max(img1.shape[0] // 2, 1)
        out = real(self, img1[:k], img2[:k])
        return {f: torch.cat([v, v.mean(0, keepdim=True).expand(
            (img1.shape[0] - k,) + v.shape[1:])]) for f, v in out.items()}

    monkeypatch.setattr(Mast3rModel, "infer_pair_batch", half)
    traffic = bench_tiny.tiny_traffic("recon")
    traffic["check"]["pairs"] = 6
    r = _recon(traffic=traffic)
    assert not r["correct"] and _checks(r)["net_gap"] > 0.1, r["checks"]


def test_recon_poses_altered(monkeypatch):
    import starst3r_tpu_torch
    real = starst3r_tpu_torch.reconstruct_scene

    def altered(*a, **k):
        rec, params = real(*a, **k)
        rec.cam2w = rec.cam2w.copy()
        rec.cam2w[:, :3, 3] *= 1.1
        return rec, params

    monkeypatch.setattr(starst3r_tpu_torch, "reconstruct_scene", altered)
    r = _recon()
    assert not r["correct"], r["checks"]


def test_recon_dense_points_altered(monkeypatch):
    from starst3r_tpu_torch import reconstruct
    real = reconstruct.Reconstruction.get_dense_pts3d

    def altered(self, clean_depth=True):
        pts, depths, confs = real(self, clean_depth)
        return [p * 1.01 for p in pts], depths, confs

    monkeypatch.setattr(reconstruct.Reconstruction, "get_dense_pts3d",
                        altered)
    r = _recon()
    assert not r["correct"] and _checks(r)["dense_gap"] > 1e-3, r["checks"]


def test_train_step_that_keeps_its_state(monkeypatch):
    from starst3r_tpu_torch.splat import train
    monkeypatch.setattr(train, "adam_update",
                        lambda grads, state, params, cfg: (params, state))
    r = bench_tiny.run_tiny("train", seconds=0.5)
    assert not r["correct"] and _checks(r)["step_gap"] > 0.5, r["checks"]


def test_train_half_of_the_cameras_left_out(monkeypatch):
    """Each step renders the first half of the cameras and scales their
    loss up to the whole count."""
    from starst3r_tpu_torch.splat import train
    real = train.train_step

    def half(state, gt, w2c, Ks, width, height, cfg, n_cams, bins=None,
             **kw):
        k = max(gt.shape[0] // 2, 1)
        if bins is not None:
            bins = type(bins)(*[b[:k] for b in bins])
        new, loss = real(state, gt[:k], w2c[:k], Ks[:k], width, height, cfg,
                         n_cams, bins=bins, **kw)
        return new, loss * gt.shape[0] / k

    monkeypatch.setattr(train, "train_step", half)
    r = bench_tiny.run_tiny("train", seconds=0.5)
    assert not r["correct"], r["checks"]


def test_train_parameters_altered(monkeypatch):
    from starst3r_tpu_torch.splat import train
    real = train.adam_update

    def altered(grads, state, params, cfg):
        new, st = real(grads, state, params, cfg)
        new = dict(new)
        new["means"] = new["means"] + 1e-3
        return new, st

    monkeypatch.setattr(train, "adam_update", altered)
    r = bench_tiny.run_tiny("train", seconds=0.5)
    assert not r["correct"] and _checks(r)["step_gap"] > 1e-2, r["checks"]


def test_render_image_altered(monkeypatch):
    from starst3r_tpu_torch.splat import train
    real = train.render

    def altered(*a, **k):
        rgb, alpha, info = real(*a, **k)
        return rgb + 0.01, alpha, info

    monkeypatch.setattr(train, "render", altered)
    r = bench_tiny.run_tiny("render", seconds=0.5)
    assert not r["correct"] and _checks(r)["render_gap_p90"] > 1e-3, \
        r["checks"]


def test_train_refine_that_keeps_its_state(monkeypatch):
    """Each refine relocates nothing and grows nothing (the step's
    position noise still comes)."""
    from starst3r_tpu_torch.splat import train
    monkeypatch.setattr(
        train, "relocate_dead",
        lambda params, *a, **k: (params, torch.zeros(
            params["opacities"].shape[0], dtype=torch.bool)))
    r = bench_tiny.run_tiny("train", seconds=0.5)
    assert not r["correct"] and _checks(r)["refine_gap"] > 1e-2, r["checks"]


def test_render_one_tile_altered(monkeypatch):
    """One 16 x 16 tile of each image comes out black. (At the tiny size
    a tile is a sixth of the image; at 512 x 384 it is 1/768, under the
    90th percentile's reach.)"""
    plant_black_tile(monkeypatch)
    r = bench_tiny.run_tiny("render", seconds=0.5)
    c = _checks(r)
    assert not r["correct"] and c["render_tile_bad"] > 0.9, r["checks"]


@pytest.mark.parametrize("kind", ["recon", "train", "render"])
def test_the_unbroken_path_is_correct(kind):
    assert bench_tiny.run_tiny(kind, seconds=0.5)["correct"]
