"""The port's CUDA kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode): each is
marked `cuda` and skips when `torch.cuda.is_available()` is false. The file
imports neither JAX nor the JAX package, so on a machine with a card and no
JAX it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 1e-4, the Pallas forward's own tolerance against its oracle
(tests/test_pallas_composite.py). The kernel multiplies transmittance
sequentially where the plain version takes chunked cumulative products, so
the two differ by float32 rounding only.
"""

import numpy as np
import pytest
import torch

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.splat import composite as comp
from starst3r_tpu_torch.splat.rasterize import rasterize, tile_entries

pytestmark = pytest.mark.cuda

ATOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _scene(n=96, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    means[:, 2] += 2.5
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = rng.uniform(0.01, 0.08, size=(n, 3)).astype(np.float32)
    opac = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    sh = rng.normal(size=(n, 4, 3)).astype(np.float32) * 0.3
    w2c = np.tile(np.eye(4, dtype=np.float32)[None], (2, 1, 1))
    w2c[1, 0, 3] = 0.15
    K = np.tile(np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]],
                         np.float32)[None], (2, 1, 1))
    return [torch.from_numpy(a) for a in (means, quats, scales, opac, sh,
                                          w2c, K)]


def _wall(n=600, seed=0):
    rng = np.random.default_rng(seed)
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = np.linspace(1.0, 5.0, n)
    means[:, :2] = rng.normal(size=(n, 2)) * 0.01
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    scales = np.full((n, 3), 2.0, np.float32)
    opac = np.full((n,), 0.999, np.float32)
    sh = np.zeros((n, 4, 3), np.float32)
    sh[:, 0] = rng.normal(size=(n, 3))
    w2c = np.eye(4, dtype=np.float32)[None]
    K = np.array([[40.0, 0, 16], [0, 40.0, 16], [0, 0, 1]], np.float32)[None]
    return [torch.from_numpy(a) for a in (means, quats, scales, opac, sh,
                                          w2c, K)]


def _compare(ent, counts, h, w, tile, tw, th, dev):
    """Kernel and plain version on the card, on the same tensors."""
    ent = ent.to(dev).contiguous()
    counts = counts.to(dev).contiguous()
    rgb_p, a_p = comp.composite_tiles_plain(ent, counts, h, w, tile, tw, th)
    before = comp.composite_tiles_cuda.launches
    rgb_k, a_k, tfin, done = comp.composite_tiles_cuda(ent, counts, h, w,
                                                       tile, tw, th)
    torch.cuda.synchronize()
    assert comp.composite_tiles_cuda.launches == before + 1
    np.testing.assert_allclose(rgb_k.cpu().numpy(), rgb_p.cpu().numpy(),
                               atol=ATOL)
    np.testing.assert_allclose(a_k.cpu().numpy(), a_p.cpu().numpy(),
                               atol=ATOL)
    counts = counts.cpu()
    c, t = counts.shape
    assert tfin.shape == (c * t, tile * tile) and done.shape == (c * t,)
    batches = (counts.reshape(-1).long() + 127) // 128
    assert bool((done.cpu().long() <= batches).all())
    return tfin.cpu(), done.cpu()


@pytest.mark.parametrize("case", ["scene", "wall", "multichunk"])
def test_kernel_matches_plain(dev, case):
    if case == "wall":
        args, kw = _wall(), dict(max_tiles_per_gaussian=9, max_per_tile=1024)
    elif case == "multichunk":
        args, kw = _scene(n=1400), dict(max_tiles_per_gaussian=4,
                                        max_per_tile=512)
    else:
        args, kw = _scene(), dict(max_tiles_per_gaussian=9, max_per_tile=128)
    ent, counts, _ = tile_entries(*args, 32, 32, 1, 16,
                                  kw["max_tiles_per_gaussian"],
                                  kw["max_per_tile"])
    tfin, done = _compare(ent, counts, 32, 32, 16, 2, 2, dev)
    if case == "wall":
        # every tile saturates in its first batch and stops there
        assert bool((done == 1).all()) and int(counts.min()) > 128
        assert float(tfin.max()) <= 1e-6
    if case == "multichunk":
        assert int(counts.max()) > 128 and int(done.max()) > 1


@pytest.mark.parametrize("tile,h,w,k", [(16, 40, 24, 200), (8, 20, 36, 64),
                                        (16, 224, 224, 128)])
def test_kernel_any_shape(dev, tile, h, w, k):
    """Any camera count, tile count and K (no multiple-of-128 or tile-group
    preconditions), ragged image edges, empty tiles."""
    rng = np.random.default_rng(tile + h + k)
    tw, th = -(-w // tile), -(-h // tile)
    c, t = 3, tw * th
    counts = rng.integers(0, k + 1, size=(c, t)).astype(np.int32)
    counts[0, 0] = 0
    ent = np.zeros((c, t, k, 9), np.float32)
    for ci in range(c):
        for ti in range(t):
            m = counts[ci, ti]
            x0, y0 = (ti % tw) * tile, (ti // tw) * tile
            ent[ci, ti, :m, 0] = rng.uniform(x0 - 4, x0 + tile + 4, m)
            ent[ci, ti, :m, 1] = rng.uniform(y0 - 4, y0 + tile + 4, m)
            ent[ci, ti, :m, 2] = rng.uniform(0.05, 0.5, m)
            ent[ci, ti, :m, 3] = rng.uniform(-0.02, 0.02, m)
            ent[ci, ti, :m, 4] = rng.uniform(0.05, 0.5, m)
            ent[ci, ti, :m, 5:8] = rng.uniform(0, 1, (m, 3))
            ent[ci, ti, :m, 8] = rng.uniform(0.05, 0.99, m)
    _compare(torch.from_numpy(ent), torch.from_numpy(counts), h, w, tile,
             tw, th, dev)


def test_kernel_degenerate_conics(dev):
    """Near-singular conics (a*c ~ b^2) put sigma within rounding of 0
    along a line of pixels, where the sigma < 0 cull jumps from an opaque
    splat to none: the kernel must round sigma as the plain version does."""
    rng = np.random.default_rng(9)
    tile, tw, th, k = 16, 2, 2, 256
    counts = np.full((1, 4), k, np.int32)
    ent = np.zeros((1, 4, k, 9), np.float32)
    for ti in range(4):
        x0, y0 = (ti % tw) * tile, (ti // tw) * tile
        # means a fraction of a pixel off pixel centres, on dx == dy lines
        off = rng.uniform(-0.3, 0.3, k)
        ent[0, ti, :, 0] = x0 + rng.integers(0, tile, k) + 0.5 + off
        ent[0, ti, :, 1] = y0 + rng.integers(0, tile, k) + 0.5 + off
        s = rng.uniform(1e2, 1e4, k)
        ent[0, ti, :, 2] = s
        ent[0, ti, :, 3] = -s * rng.uniform(0.999999, 1.0, k)
        ent[0, ti, :, 4] = s
        ent[0, ti, :, 5:8] = rng.uniform(0, 1, (k, 3))
        ent[0, ti, :, 8] = 1.0
    _compare(torch.from_numpy(ent), torch.from_numpy(counts), 32, 32, tile,
             tw, th, dev)


def test_rasterize_on_cuda_matches_cpu(dev):
    args = _scene()
    kw = dict(width=32, height=32, sh_degree=1, tile_size=16,
              max_tiles_per_gaussian=9, max_per_tile=128)
    rgb_c, a_c, info_c = rasterize(*args, **kw)
    before = comp.composite_tiles_cuda.launches
    rgb_g, a_g, info_g = rasterize(*(a.to(dev) for a in args), **kw)
    torch.cuda.synchronize()
    assert comp.composite_tiles_cuda.launches == before + 1
    assert rgb_g.is_cuda
    np.testing.assert_allclose(rgb_g.cpu().numpy(), rgb_c.numpy(), atol=ATOL)
    np.testing.assert_allclose(a_g.cpu().numpy(), a_c.numpy(), atol=ATOL)
    np.testing.assert_array_equal(info_g["tile_overflow"].cpu().numpy(),
                                  info_c["tile_overflow"].numpy())


def test_wrapper_rejects_bad_inputs(dev):
    ent = torch.zeros((1, 4, 8, 9), device=dev)
    counts = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        comp.composite_tiles_cuda(ent.double(), counts, 32, 32, 16, 2, 2)
    with pytest.raises(ValueError):
        comp.composite_tiles_cuda(ent, counts.long(), 32, 32, 16, 2, 2)
    with pytest.raises(ValueError):
        comp.composite_tiles_cuda(ent, counts, 64, 32, 16, 2, 2)


def test_scene_defaults_to_cuda(dev):
    """A tiny scene with no device argument runs on the card end to end
    and renders through the kernel."""
    rng = np.random.default_rng(1)
    imgs = [rng.uniform(-1, 1, size=(3, 64, 64)).astype(np.float32)
            for _ in range(3)]
    model = stt.Mast3rModel.init_random(stt.ModelConfig.tiny())
    assert next(model.net.parameters()).is_cuda
    cfg = stt.default_config()
    import dataclasses
    cfg = dataclasses.replace(cfg, ga=dataclasses.replace(cfg.ga, niter1=15,
                                                          niter2=8))
    scene = stt.Scene(config=cfg)
    assert scene.device.type == "cuda"
    scene.add_images(model, imgs[:2])
    scene.add_images(model, imgs[2:])
    scene.init_3dgs()
    assert scene.gs_state.params["means"].is_cuda
    before = comp.composite_tiles_cuda.launches
    rgb, alpha, _ = scene.render_3dgs_original(64, 64)
    assert comp.composite_tiles_cuda.launches == before + 1
    assert rgb.shape == (3, 64, 64, 3) and bool(torch.isfinite(rgb).all())
