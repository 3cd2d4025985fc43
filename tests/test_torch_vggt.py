"""VGGT (`starst3r_tpu_torch/models/vggt.py`) held to the plain float32
reference `tests/vggt_reference.py` on the CPU, on the tiny config's
seeded random weights, at 56 x 42 (3 views: a 3 x 4 patch grid, so
DINOv2's position table is resampled and the DPT's coarsest level is
2 x 2, not half of 3 x 4) and 56 x 56 (4 views, the square grid):

  - the DINOv2 patch tokens, every aggregator iteration, every camera-head
    iteration, both DPT heads, the pose encoding's cameras and
    `reconstruct_scene`'s cameras and cleaned dense points;
  - permuting views 1..S-1 permutes every output the same way (view 0
    holds the scene's frame: its tokens come from index 0 of the tables);
  - a global attention that sees only its own frame leaves the reference
    by far more than the tolerance;
  - the fused attention route: taken by every VGGT attention but the
    camera head's, and by nothing of MASt3R's forward;
  - `load_images(mode="crop")`, VGGT's preprocessing.

Tolerance: the port and the reference compute the same float32
arithmetic in other orders (fused qkv reshapes, the DPT's module calls,
the reference's per-head attention); they agree within ~1e-5 of each
output's scale here. TOL = 1e-4 of the scale (the largest magnitude)
leaves that room tenfold; a bfloat16 computation misses by ~4e-3.
"""

import dataclasses

import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401

import vggt_reference as ref

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.config import VGGTConfig
from starst3r_tpu_torch.models import mast3r, vggt
from starst3r_tpu_torch.ops import attention

TOL = 1e-4
SIZES = {"rect": (3, 42, 56), "square": (4, 56, 56)}


def cfg_dict(cfg: VGGTConfig) -> dict:
    """The reference's configuration keys (the benchmark's file's) of a
    `VGGTConfig`."""
    return dict(
        patch_size=cfg.patch_size, img_size=cfg.img_size, embed_dim=cfg.dim,
        enc_depth=cfg.enc_depth, num_heads=cfg.heads,
        mlp_ratio=cfg.mlp_ratio,
        num_register_tokens=cfg.num_register_tokens, depth=cfg.depth,
        head_layers=list(cfg.head_layers),
        dpt_features=cfg.dpt_feature_dim,
        dpt_out_channels=list(cfg.dpt_layer_dims),
        dpt_last_dim=cfg.dpt_last_dim, frames_chunk_size=cfg.frames_chunk,
        camera_trunk_depth=cfg.camera_depth,
        camera_num_heads=cfg.camera_heads,
        camera_iterations=cfg.camera_iters)


@pytest.fixture(scope="module")
def model():
    return stt.VGGTModel.init_random(VGGTConfig.tiny(), seed=3,
                                     device="cpu")


@pytest.fixture(scope="module")
def reference(model):
    return ref.VGGT(model.state_dict(), cfg_dict(model.cfg))


def images(size: str, seed: int = 0) -> torch.Tensor:
    s, h, w = SIZES[size]
    return torch.rand(s, 3, h, w, generator=torch.Generator().manual_seed(
        seed))


def assert_close(got, want, what):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    assert got.shape == want.shape, what
    scale = float(want.abs().max())
    gap = float((got - want).abs().max())
    assert gap <= TOL * max(scale, 1.0), f"{what}: {gap} of {scale}"


@pytest.fixture(scope="module")
def outputs(model, reference):
    """{size: (port outputs with the aggregator's iterations, reference
    outputs)}."""
    out = {}
    for size in SIZES:
        imgs = images(size)
        agg = {}
        real = model.net.aggregator.forward

        def keep(x, real=real, agg=agg):
            res = real(x)
            agg.update(res)
            return res

        model.net.aggregator.forward = keep
        try:
            got = model.infer(list(imgs.numpy()))
        finally:
            del model.net.aggregator.forward
        with torch.no_grad():
            want = reference.forward(imgs)
        out[size] = (dict(got, tokens=agg), want)
    return out


@pytest.mark.parametrize("size", SIZES)
def test_dinov2_tokens(model, reference, size):
    imgs = images(size)
    mean = torch.tensor(ref.MEAN).view(1, 3, 1, 1)
    std = torch.tensor(ref.STD).view(1, 3, 1, 1)
    x = (imgs - mean) / std
    with torch.no_grad():
        got = model.net.aggregator.patch_embed(x)
        want = reference.encode(x)
    assert_close(got, want, "DINOv2 patch tokens")


@pytest.mark.parametrize("size", SIZES)
def test_every_aggregator_iteration(outputs, model, size):
    got, want = outputs[size]
    assert sorted(got["tokens"]) == list(range(model.cfg.depth))
    for i in range(model.cfg.depth):
        assert_close(got["tokens"][i], want["tokens"][i], f"iteration {i}")


@pytest.mark.parametrize("size", SIZES)
def test_every_camera_iteration(outputs, model, size):
    got, want = outputs[size]
    assert len(got["pose_enc_list"]) == model.cfg.camera_iters
    for i, (g, w) in enumerate(zip(got["pose_enc_list"],
                                   want["pose_enc_list"])):
        assert_close(g, w, f"camera iteration {i}")


@pytest.mark.parametrize("key", ["depth", "depth_conf", "world_points",
                                 "world_points_conf"])
@pytest.mark.parametrize("size", SIZES)
def test_dpt_heads(outputs, size, key):
    got, want = outputs[size]
    assert_close(got[key], want[key], key)


def test_pose_encoding_to_cameras():
    gen = torch.Generator().manual_seed(4)
    enc = torch.randn(5, 9, generator=gen)
    enc[:, 7:] = torch.rand(5, 2, generator=gen) + 0.5       # FoVs
    cam2w, K = vggt.pose_encoding_to_cameras(enc, 42, 56)
    want_c2w, want_K = ref.cameras(enc.double(), 42, 56)
    assert_close(cam2w, want_c2w, "cam2w")
    assert_close(K, want_K, "K")


@pytest.mark.parametrize("size", SIZES)
def test_reconstruct_scene_cameras_and_dense_points(model, reference, size):
    imgs = images(size, seed=1)
    s, h, w = SIZES[size]
    rec, params = stt.reconstruct_scene(model, list(imgs.numpy()),
                                        device="cpu")
    assert params is None and rec.ga_params is None and rec.views == []
    assert rec.core_depth.shape == (s, 0)
    with torch.no_grad():
        out = reference.forward(imgs)
    c2w, K = ref.cameras(out["pose_enc"].double(), h, w)
    assert_close(rec.cam2w, c2w, "cam2w")
    assert_close(rec.intrinsics, K, "K")
    pts, depths, confs = rec.get_dense_pts3d(clean_depth=True)
    # the reference unprojects the program's cameras and depth, so that
    # the clean-up's nearest-pixel tests see the same numbers
    wp, wd, wc = ref.unproject(torch.as_tensor(rec.depth).reshape(s, -1),
                               torch.as_tensor(rec.depth_conf).reshape(s, -1),
                               torch.as_tensor(rec.intrinsics),
                               torch.as_tensor(rec.cam2w), h, w)
    assert_close(np.stack(pts), wp, "dense points")
    assert_close(np.stack(depths), wd, "dense depth")
    assert_close(np.stack(confs), wc, "cleaned confidence")
    assert float((wc == 1).float().mean()) > 1e-3    # the clean-up acted
    assert_close(rec.depth, out["depth"][..., 0], "depth")


def test_permuting_views_permutes_the_outputs(model):
    imgs = images("square", seed=2)
    perm = [0, 3, 1, 2]
    a = model.infer(list(imgs.numpy()))
    b = model.infer(list(imgs[perm].numpy()))
    for key in vggt.OUT_KEYS:
        assert_close(b[key], a[key][perm], key)
    # view 0 is the frame: the same views with another first view differ
    c = model.infer(list(imgs[[1, 0, 2, 3]].numpy()))
    gap = float((c["pose_enc"][[1, 0, 2, 3]] - a["pose_enc"]).abs().max())
    assert gap > 100 * TOL


def plant_frame_only_global(mp):
    """Each global block attends within its own frame only."""
    def frame_only(self, blk, x, rope_all):
        p = x.shape[1]
        return blk(x, (rope_all[0][:p], rope_all[1][:p]))

    mp.setattr(vggt.Aggregator, "global_block", frame_only)


def test_frame_only_global_attention_is_far_from_the_reference(
        model, outputs, monkeypatch):
    plant_frame_only_global(monkeypatch)
    imgs = images("rect")
    got = model.infer(list(imgs.numpy()))
    want = outputs["rect"][1]
    for key in ("pose_enc", "depth", "world_points"):
        scale = float(want[key].abs().max())
        gap = float((got[key] - want[key]).abs().max())
        assert gap > 100 * TOL * scale, (key, gap, scale)


def test_the_fused_route_is_vggts_alone(model, monkeypatch):
    monkeypatch.setattr(attention.fused_sdpa, "launches", 0)
    m = stt.Mast3rModel.init_random(stt.ModelConfig.tiny(), device="cpu")
    img = torch.rand(2, 32, 32, 3) * 2 - 1
    m.infer_pair_batch(img, img.flip(0))
    assert attention.fused_sdpa.launches == 0
    model.infer(list(images("rect").numpy()))
    cfg = model.cfg
    assert attention.fused_sdpa.launches == cfg.enc_depth + 2 * cfg.depth


def test_mast3r_dpt_is_the_2x_head_bit_for_bit():
    """MASt3R's DPT head after VGGT's changes to its modules: the 2x
    fusion chain of the reference, bit for bit (its odd-grid failure is
    tests/test_torch_rect.py::test_odd_patch_count_raises_in_both)."""
    from starst3r_tpu_torch.models.heads import _resize_align_corners
    torch.manual_seed(0)
    head = mast3r.DownstreamHead(stt.ModelConfig.tiny()).dpt
    states = [torch.randn(2, 24, d) for d in (64, 48, 48, 48)]
    feats = []
    for i, st in enumerate(states):
        f = head.act_postprocess[i](st.transpose(1, 2).reshape(2, -1, 4, 6))
        feats.append(getattr(head.scratch, f"layer{i + 1}_rn")(f))
    sc = head.scratch
    x = sc.refinenet1(sc.refinenet2(sc.refinenet3(
        sc.refinenet4(feats[3]), feats[2]), feats[1]), feats[0])
    x = _resize_align_corners(head.head["0"](x), 64, 96)
    want = head.head["4"](torch.relu(head.head["2"](x))).permute(0, 2, 3, 1)
    assert torch.equal(head(states, 4, 6, 64, 96), want)


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (300, 900)])
def test_load_images_crop_mode(tmp_path, hw):
    h, w = hw
    arr = (np.random.default_rng(0).random((h, w, 3)) * 255).astype(np.uint8)
    path = tmp_path / "a.png"
    Image.fromarray(arr).save(path)
    (got,) = stt.load_images([path], size=518, mode="crop")
    new_h = round(h * 518 / w / 14) * 14
    want = np.asarray(Image.fromarray(arr).resize((518, new_h),
                                                  Image.BICUBIC))
    top = max(0, (new_h - 518) // 2)
    want = want[top:top + 518].astype(np.float32) / 255.0
    assert got.shape == (3, min(new_h, 518), 518)
    np.testing.assert_array_equal(got, want.transpose(2, 0, 1))
    if hw == (480, 640):
        assert got.shape == (3, 392, 518)       # 28 x 37 patches
    with pytest.raises(ValueError):
        stt.load_images([path], size=518, mode="crop", impl="native")


def test_the_cli_reconstructs_with_a_vggt_preset(tmp_path):
    """`reconstruct --preset vggt_tiny` on the CPU: crop-mode loading, one
    forward, the dense points, 3DGS, the output files."""
    from starst3r_tpu_torch import cli
    rng = np.random.default_rng(0)
    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    for k in range(3):
        Image.fromarray((rng.random((48, 64, 3)) * 255).astype(np.uint8)
                        ).save(imgdir / f"v{k}.png")
    out = tmp_path / "out"
    rc = cli.main(["--device", "cpu", "reconstruct", "--imgdir", str(imgdir),
                   "--out", str(out), "--res", "56", "--preset", "vggt_tiny",
                   "--gs-iters", "2"])
    assert rc == 0
    c2w = np.load(out / "c2w.npy")
    assert c2w.shape == (3, 4, 4) and np.isfinite(c2w).all()
    assert np.load(out / "intrinsics.npy")[0, :2, 2].tolist() == [28.0, 21.0]
    assert (out / "points.ply").stat().st_size > 0
    assert (out / "scene.ckpt").exists()


def test_the_reference_is_the_benchmarks_copy():
    """tests/vggt_reference.py and benchmark/reference/vggt.py are one
    reference in two homes: the CPU tests' and the benchmark's."""
    from pathlib import Path
    here = Path(__file__).resolve().parent
    assert (here / "vggt_reference.py").read_bytes() == (
        here.parent / "benchmark" / "reference" / "vggt.py").read_bytes()


def test_vggt_1b_has_the_published_widths():
    with torch.device("meta"):
        net = vggt.VGGTNet(VGGTConfig.vggt_1b())
    n = sum(p.numel() for p in net.parameters())
    assert n == 1_190_596_120          # ~1.19 B without the track head
    agg = net.aggregator
    assert len(agg.frame_blocks) == len(agg.global_blocks) == 24
    assert agg.frame_blocks[0].attn.head_dim == 64
    assert agg.patch_embed.pos_embed.shape == (1, 1 + 37 * 37, 1024)
    assert net.camera_head.trunk[0].attn.qkv.in_features == 2048
    assert dataclasses.asdict(VGGTConfig.vggt_1b())["head_layers"] == (
        4, 11, 17, 23)
