"""Fast3R (`starst3r_tpu_torch/models/fast3r.py`) held to the plain float32
reference `benchmark/reference/fast3r.py` on the CPU, on the tiny config's
seeded random weights, at 64 x 96 (3 views: a 4 x 6 patch grid):

  - both heads' points and confidences, the cameras from them (the focal
    of view 0's global pointmap, each view's Procrustes), and
    `reconstruct_scene`'s cameras and dense points;
  - the Procrustes recovers a known rigid motion;
  - a fusion that attends within each view leaves the reference by far
    more than the tolerance;
  - `reconstruct_scene`, `Scene.add_images` and the command line with
    ``--preset fast3r_tiny`` end to end;
  - the rotate-once route: one `rope_rotate_qk` call a fusion block (24 at
    `fast3r_vitl_512`'s depth) once its calls reach `ROTATE_ONCE_KEYS`,
    none in MASt3R's forward, and the attention kernels' refusal of a
    tensor spanning 2^31 elements;
  - the published widths of `fast3r_vitl_512`.

Tolerance: the port and the reference compute the same float32
arithmetic in other orders (the fused qkv, the DPT's module calls, the
reference's per-head attention); they agree within ~4e-6 of each output's
scale here. TOL = 1e-4 of the scale leaves that room tenfold or more.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.config import Fast3RConfig
from starst3r_tpu_torch.models import fast3r
from starst3r_tpu_torch.ops import attention
from starst3r_tpu_torch.utils.camera import rigid_procrustes
from starst3r_tpu_torch.utils.se3 import quat_to_rotmat

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "benchmark"))
from reference import fast3r as ref  # noqa: E402

TOL = 1e-4
VIEWS, H, W = 3, 64, 96


def cfg_dict(cfg: Fast3RConfig) -> dict:
    """The reference's configuration keys (the benchmark's file's) of a
    `Fast3RConfig`."""
    return dict(
        patch_size=cfg.patch_size, enc_embed_dim=cfg.enc_dim,
        enc_depth=cfg.enc_depth, enc_num_heads=cfg.enc_heads,
        dec_embed_dim=cfg.dec_dim, dec_depth=cfg.dec_depth,
        dec_num_heads=cfg.dec_heads, mlp_ratio=cfg.mlp_ratio,
        dpt_feature_dim=cfg.dpt_feature_dim,
        dpt_layer_dims=list(cfg.dpt_layer_dims),
        dpt_last_dim=cfg.dpt_last_dim)


@pytest.fixture(scope="module")
def model():
    return stt.Fast3RModel.init_random(Fast3RConfig.tiny(), seed=3,
                                       device="cpu")


@pytest.fixture(scope="module")
def reference(model):
    return ref.Fast3R(model.state_dict(), cfg_dict(model.cfg))


def images(seed: int = 0) -> torch.Tensor:
    return torch.rand(VIEWS, 3, H, W, generator=torch.Generator()
                      .manual_seed(seed)) * 2 - 1


def assert_close(got, want, what):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape, what
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert gap <= TOL * max(scale, 1.0), f"{what}: {gap} of {scale}"


@pytest.fixture(scope="module")
def outputs(model, reference):
    imgs = images()
    got = model.infer(list(imgs.numpy()))
    with torch.no_grad():
        want = reference.forward(imgs)
    return got, want


@pytest.mark.parametrize("key", ref.OUT_KEYS)
def test_both_heads(outputs, key):
    got, want = outputs
    assert_close(got[key], want[key], key)


def test_the_layout_is_the_state_dict(model):
    sd = model.state_dict()
    lay = ref.layout(cfg_dict(model.cfg))
    assert [k for k, _, _ in lay] == list(sd)
    assert all(tuple(sd[k].shape) == shape for k, shape, _ in lay)


def test_cameras_from_the_pointmaps(outputs):
    got, _ = outputs
    c2w, K = fast3r.pointmap_cameras(*(got[k] for k in ref.OUT_KEYS))
    want_c2w, want_K = ref.cameras(*(got[k] for k in ref.OUT_KEYS))
    assert_close(c2w, want_c2w, "cam2w")
    assert_close(K, want_K, "K")
    rot = c2w[:, :3, :3]
    assert_close(rot @ rot.transpose(1, 2), torch.eye(3).expand(VIEWS, 3, 3),
                 "orthonormal")
    assert bool((torch.linalg.det(rot) > 0).all())


def test_reconstruct_scene_cameras_and_dense_points(model, reference):
    imgs = images(seed=1)
    rec, params = stt.reconstruct_scene(model, list(imgs.numpy()),
                                        device="cpu")
    assert params is None and rec.ga_params is None and rec.views == []
    with torch.no_grad():
        out = reference.forward(imgs)
    c2w, K = ref.cameras(*(out[k] for k in ref.OUT_KEYS))
    assert_close(rec.cam2w, c2w, "cam2w")
    assert_close(rec.intrinsics, K, "K")
    assert_close(rec.depth, out["pts_local"][..., 2], "depth")
    assert_close(rec.depth_conf, out["conf_local"], "depth confidence")
    assert_close(np.stack(rec.imgs), imgs.permute(0, 2, 3, 1) * 0.5 + 0.5,
                 "display images")
    for clean in (False, True):
        pts, depths, confs = rec.get_dense_pts3d(clean_depth=clean)
        wp, wd, _ = ref.unproject(
            torch.as_tensor(rec.depth).reshape(VIEWS, -1),
            torch.as_tensor(rec.depth_conf).reshape(VIEWS, -1),
            torch.as_tensor(rec.intrinsics), torch.as_tensor(rec.cam2w), H,
            W, clean=False)
        assert_close(np.stack(pts), wp, "dense points")
        assert_close(np.stack(depths), wd, "dense depth")


def test_procrustes_recovers_a_known_rigid_motion():
    g = torch.Generator().manual_seed(0)
    src = torch.randn(5, 400, 3, generator=g, dtype=torch.float64)
    q = torch.randn(5, 4, generator=g, dtype=torch.float64)
    rot = quat_to_rotmat(q / q.norm(dim=-1, keepdim=True))
    trans = torch.randn(5, 3, generator=g, dtype=torch.float64) * 3
    dst = torch.einsum("bij,bnj->bni", rot, src) + trans[:, None]
    weight = torch.rand(5, 400, generator=g, dtype=torch.float64) + 0.5
    got_r, got_t = rigid_procrustes(src, dst, weight)
    assert torch.allclose(got_r, rot, atol=1e-12)
    assert torch.allclose(got_t, trans, atol=1e-12)
    # a mirror image is no rotation: the determinant's sign is corrected
    mirror = dst * torch.tensor([1.0, 1.0, -1.0], dtype=torch.float64)
    r, _ = rigid_procrustes(src, mirror, weight)
    assert torch.allclose(torch.linalg.det(r), torch.ones(5,
                                                          dtype=r.dtype))


def test_the_image_index_embedding():
    e = fast3r.image_index_embedding(3, 8, "cpu")
    assert torch.equal(e[0], torch.tensor([0.0] * 4 + [1.0] * 4))
    assert torch.allclose(e, ref.index_embedding(3, 8, "cpu"))


def plant_fusion_within_views(mp):
    """Every fusion block attends within its own view only."""
    from starst3r_tpu_torch.ops.rope import rope_2d_freqs

    def within_views(self, feats, pos):
        cfg = self.cfg
        n, p, _ = feats.shape
        x = self.decoder_embed(feats) + fast3r.image_index_embedding(
            n, cfg.dec_dim, feats.device)[:, None]
        rope = rope_2d_freqs(pos[None], cfg.dec_dim // cfg.dec_heads,
                             cfg.rope_base)
        hooks = {}
        for i, blk in enumerate(self.dec_blocks, 1):
            x = blk(x, rope)
            hooks[i] = x
        k1, k2 = fast3r._dpt_hooks(cfg.dec_depth)
        return [hooks[k1], hooks[k2], self.dec_norm(x)]

    mp.setattr(fast3r.Fast3RNet, "fuse", within_views)


def test_fusion_within_views_is_far_from_the_reference(model, outputs,
                                                       monkeypatch):
    plant_fusion_within_views(monkeypatch)
    got = model.infer(list(images().numpy()))
    want = outputs[1]
    for key in ("pts_global", "pts_local"):
        scale = float(want[key].abs().max())
        gap = float((got[key] - want[key]).abs().max())
        assert gap > 100 * TOL * scale, (key, gap, scale)


def test_scene_add_images(model, tmp_path):
    scene = stt.Scene(cache_dir=str(tmp_path), device="cpu")
    scene.add_images(model, list(images(seed=2).numpy()), conf_thres=1.0)
    assert scene.c2w.shape == (VIEWS, 4, 4) and np.isfinite(scene.c2w).all()
    assert scene.intrinsics[0, :2, 2].tolist() == [W / 2, H / 2]
    assert len(scene.dense_pts) == VIEWS and scene.dense_pts_flat.shape[1] == 3
    assert scene.reconstruction.depth.shape == (VIEWS, H, W)


def test_the_cli_reconstructs_with_a_fast3r_preset(tmp_path):
    """`reconstruct --preset fast3r_tiny` on the CPU: MASt3R's loading,
    one forward, the dense points, 3DGS, the output files."""
    from starst3r_tpu_torch import cli
    rng = np.random.default_rng(0)
    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    for k in range(3):
        Image.fromarray((rng.random((48, 64, 3)) * 255).astype(np.uint8)
                        ).save(imgdir / f"v{k}.png")
    out = tmp_path / "out"
    rc = cli.main(["--device", "cpu", "reconstruct", "--imgdir", str(imgdir),
                   "--out", str(out), "--res", "64", "--preset",
                   "fast3r_tiny", "--gs-iters", "2"])
    assert rc == 0
    c2w = np.load(out / "c2w.npy")
    assert c2w.shape == (3, 4, 4) and np.isfinite(c2w).all()
    # 64 x 48 photos cropped to 64 x 32: the principal point at the centre
    assert np.load(out / "intrinsics.npy")[0, :2, 2].tolist() == [32.0, 16.0]
    assert (out / "points.ply").stat().st_size > 0
    assert (out / "scene.ckpt").exists()


def test_the_fusion_rotates_once_a_block_and_mast3r_never(monkeypatch):
    """MASt3R's calls (768 keys at most, one view at 512 x 384) stay below
    `ROTATE_ONCE_KEYS` and the 49,152 keys of the benchmark's scene reach
    it. MASt3R's forward rotates as its kernel loads and calls no
    rotation; with the rule's key count moved down to the tiny scene's,
    one `rope_rotate_qk` call and one attention call a fusion block: 24
    rotations at `fast3r_vitl_512`'s fusion depth (the tiny widths)."""
    assert 768 < attention.ROTATE_ONCE_KEYS <= 64 * 768
    monkeypatch.setattr(attention.rope_rotate_qk, "launches", 0)
    monkeypatch.setattr(attention.rope_attention, "launches", 0)
    m = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(), device="cpu")
    img = torch.rand(2, 32, 32, 3) * 2 - 1
    m.infer_pair_batch(img, img.flip(0))
    mcfg = m.cfg
    assert attention.rope_rotate_qk.launches == 0
    assert attention.rope_attention.launches == \
        mcfg.enc_depth + 4 * mcfg.dec_depth
    cfg = dataclasses.replace(
        Fast3RConfig.tiny(),
        dec_depth=Fast3RConfig.fast3r_vitl_512().dec_depth)
    f = stt.Fast3RModel.init_random(cfg, device="cpu")
    # 2 views of 2 x 2 patches: the fusion's calls have 8 keys, the
    # encoder's 4
    monkeypatch.setattr(attention, "ROTATE_ONCE_KEYS", 8)
    attention.rope_attention.launches = 0
    f.infer([np.zeros((3, 32, 32), np.float32)] * 2)
    assert attention.rope_rotate_qk.launches == 24
    assert attention.rope_attention.launches == cfg.enc_depth + 24


def test_the_kernels_refuse_a_span_past_2_31():
    """A view of a (1, T, 3, 16, 64) `qkv` whose elements span 2^31 from
    its start, and a contiguous one just under: the first raises
    ValueError (shapes alone: meta tensors, nothing allocated)."""
    t = 2 ** 31 // (3 * 16 * 64) + 2
    q, k, v = torch.empty(1, t, 3, 16, 64, device="meta").unbind(2)
    with pytest.raises(ValueError):
        attention._check_span(q=q, k=k, v=v)
    ok = torch.empty(1, 2 ** 31 // (16 * 64) - 1, 16, 64, device="meta")
    attention._check_span(q=ok)


def test_fast3r_vitl_512_has_the_published_widths():
    with torch.device("meta"):
        net = fast3r.Fast3RNet(Fast3RConfig.fast3r_vitl_512())
    n = sum(p.numel() for p in net.parameters())
    assert n == 647_551_368          # ~0.65 B
    assert len(net.enc_blocks) == len(net.dec_blocks) == 24
    assert net.dec_blocks[0].attn.head_dim == 64
    assert net.decoder_embed.in_features == net.decoder_embed.out_features \
        == 1024
    assert net.head_local.head["4"].out_channels == 4
    assert stt.model_preset("fast3r_vitl_512") == \
        Fast3RConfig.fast3r_vitl_512()
