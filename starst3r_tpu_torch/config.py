"""Configuration dataclasses for the whole framework.

Every default reproduces the reference behavior spec (see SURVEY.md §5 "Config"
row): hyperparameters in the reference live as function defaults
(reference: starster/reconstruct.py:60-69,116-127; starster/gs.py:97-104;
starster/scene.py:101,157). Here they are collected into one declarative tree
so CLI / tests / benchmarks can override them uniformly.

This is the port's own copy of `starst3r_tpu/config.py`: the same
dataclasses, fields, defaults and presets, so one set of values configures
both packages. `GAConfig.jit_chunk` is the GA's steps per host read in both
(per jitted device call in the JAX package, per run of replays of the
captured step on the card in the port). The port reads every field but
`MeshConfig`'s (its meshes are `parallel.make_mesh`'s arguments, not this
config's axis names and sizes) and `ModelConfig.desc_conf`, which neither
package reads: the descriptor confidence is always on.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


@dataclass(frozen=True)
class ImageConfig:
    """Image pipeline (reference: starster/image.py:43-109).

    - longest edge resized to ``size`` (bicubic)
    - center-crop H and W down to a multiple of ``crop_multiple``
    - normalize with mean/std 0.5
    """

    size: int = 224                 # reference default resolution (image.py:79)
    crop_multiple: int = 16         # patch size; reference crops to mult of 8,
                                    # we require mult of patch (16) so the ViT
                                    # needs no extra pad. compat=8 available.
    mean: float = 0.5
    std: float = 0.5


@dataclass(frozen=True)
class ModelConfig:
    """MASt3R-style asymmetric two-view network (SURVEY §2b rows 1-2).

    ViT encoder (shared both views) + decoder with cross-attention between the
    two views' token streams, 2D RoPE; DPT pointmap head + local-descriptor
    head ("catmlpdpt" analog).
    """

    name: str = "tiny"
    patch_size: int = 16
    # encoder
    enc_depth: int = 12
    enc_dim: int = 768
    enc_heads: int = 12
    # decoder
    dec_depth: int = 8
    dec_dim: int = 512
    dec_heads: int = 8
    # heads
    desc_dim: int = 24              # local feature descriptor dim
    desc_conf: bool = True
    rope_base: float = 100.0        # croco-style 2D RoPE frequency base
    mlp_ratio: float = 4.0
    dtype: str = "bfloat16"         # activation dtype on the accelerator
    # pointmap output parameterization: exp depth along ray, metric scale
    pointmap_mode: str = "exp"
    # DPT head geometry — defaults are the public MASt3R catmlpdpt layout
    # (feature_dim=256, layer_dims 96/192/384/768, last_dim=128), so the
    # converted checkpoint maps 1:1 (io/torch_convert.py)
    dpt_feature_dim: int = 256
    dpt_layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    dpt_last_dim: int = 128
    desc_hidden_factor: float = 4.0  # reference hidden_dim_factor

    @staticmethod
    def tiny() -> "ModelConfig":
        """Random-init CPU-testable model (BASELINE config 1)."""
        return ModelConfig(
            name="tiny", enc_depth=2, enc_dim=64, enc_heads=2,
            dec_depth=2, dec_dim=48, dec_heads=2, desc_dim=8,
            dtype="float32",
            dpt_feature_dim=32, dpt_layer_dims=(8, 12, 16, 24),
            dpt_last_dim=16,
        )

    @staticmethod
    def small() -> "ModelConfig":
        return ModelConfig(
            name="small", enc_depth=6, enc_dim=384, enc_heads=6,
            dec_depth=4, dec_dim=256, dec_heads=4, desc_dim=16,
            dpt_feature_dim=64, dpt_layer_dims=(16, 32, 48, 64),
            dpt_last_dim=32,
        )

    @staticmethod
    def base() -> "ModelConfig":
        return ModelConfig(
            name="base", enc_depth=12, enc_dim=768, enc_heads=12,
            dec_depth=8, dec_dim=512, dec_heads=8, desc_dim=24,
        )

    @staticmethod
    def large() -> "ModelConfig":
        """ViT-Large encoder / ViT-Base decoder — the reference checkpoint
        geometry (MASt3R_ViTLarge_BaseDecoder, SURVEY §2b row 1)."""
        return ModelConfig(
            name="large", enc_depth=24, enc_dim=1024, enc_heads=16,
            dec_depth=12, dec_dim=768, dec_heads=12, desc_dim=24,
        )


@dataclass(frozen=True)
class VGGTConfig:
    """VGGT, the Visual Geometry Grounded Transformer (Wang et al., CVPR
    2025, arXiv:2503.11651; facebookresearch/vggt, `facebook/VGGT-1B`):
    all S views of a scene in one forward, returning each view's camera,
    depth map and world-point map with their confidences
    (`models/vggt.py`).

    A DINOv2 ViT-L/14 with register tokens embeds each view; the
    aggregator then alternates a frame block (attention within each view)
    and a global block (attention over all S x P tokens of the scene)
    ``depth`` times; a camera head refines a pose encoding ``camera_iters``
    times over the views' camera tokens; two DPT heads read iterations
    ``head_layers``. The track head is not built (no path of the system
    asks for tracks)."""

    name: str = "vggt_1b"
    patch_size: int = 14
    img_size: int = 518             # DINOv2's position table: 37 x 37 patches
    enc_depth: int = 24             # DINOv2 blocks
    dim: int = 1024
    heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    depth: int = 24                 # aggregator iterations (frame + global)
    rope_base: float = 100.0
    head_layers: Tuple[int, int, int, int] = (4, 11, 17, 23)
    dpt_feature_dim: int = 256
    dpt_layer_dims: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    dpt_last_dim: int = 32
    frames_chunk: int = 8           # the DPT heads' views per pass
    camera_depth: int = 4           # camera head trunk blocks (2 x dim wide)
    camera_heads: int = 16
    camera_iters: int = 4
    # the aggregator's autocast dtype; the camera and DPT heads run in
    # float32 with autocast off, as VGGT's `forward` runs them
    dtype: str = "bfloat16"

    @staticmethod
    def vggt_1b() -> "VGGTConfig":
        """The published VGGT-1B widths (without the track head)."""
        return VGGTConfig()

    @staticmethod
    def tiny() -> "VGGTConfig":
        """Random-init CPU-testable VGGT: 56 x 42 input, float32."""
        return VGGTConfig(
            name="vggt_tiny", img_size=56, enc_depth=2, dim=64, heads=2,
            depth=4, head_layers=(0, 1, 2, 3), dpt_feature_dim=16,
            dpt_layer_dims=(8, 12, 16, 16), dpt_last_dim=8, frames_chunk=2,
            camera_depth=2, camera_heads=2, dtype="float32")


@dataclass(frozen=True)
class Fast3RConfig:
    """Fast3R (Yang et al., CVPR 2025, arXiv:2501.13928; facebookresearch/
    fast3r, `Fast3R_ViT_Large_512`): DUSt3R's trunk made N-view, all views
    of a scene in one forward (`models/fast3r.py`).

    CroCo's ViT encoder embeds each view on its own; a linear map and an
    image-index embedding then feed ``dec_depth`` fusion blocks that attend
    over every token of every view at once, with 2D RoPE on each token's
    own patch; two DPT heads read [encoder output, fusion blocks depth/2,
    3 depth/4, the normed last] and give each view's points in its own
    camera frame (local) and in view 0's (global), with confidences."""

    name: str = "fast3r_vitl_512"
    patch_size: int = 16
    enc_depth: int = 24
    enc_dim: int = 1024
    enc_heads: int = 16
    dec_depth: int = 24             # fusion blocks
    dec_dim: int = 1024
    dec_heads: int = 16
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    pointmap_mode: str = "exp"
    dpt_feature_dim: int = 256
    dpt_layer_dims: Tuple[int, int, int, int] = (96, 192, 384, 768)
    dpt_last_dim: int = 128
    enc_chunk: int = 16             # views a call of the encoder
    heads_chunk: int = 8            # views a pass of the DPT heads
    # the encoder's and fusion's autocast dtype; the DPT heads run under it
    # too, their last convolution in float32, as MASt3R's do in the port
    dtype: str = "bfloat16"

    @staticmethod
    def fast3r_vitl_512() -> "Fast3RConfig":
        """The published Fast3R ViT-L/512 widths."""
        return Fast3RConfig()

    @staticmethod
    def tiny() -> "Fast3RConfig":
        """Random-init CPU-testable Fast3R, float32."""
        return Fast3RConfig(
            name="fast3r_tiny", enc_depth=2, enc_dim=64, enc_heads=2,
            dec_depth=2, dec_dim=48, dec_heads=2, dpt_feature_dim=32,
            dpt_layer_dims=(8, 12, 16, 24), dpt_last_dim=16, enc_chunk=2,
            heads_chunk=2, dtype="float32")


_MODEL_PRESETS = {"tiny": ModelConfig.tiny, "small": ModelConfig.small,
                  "base": ModelConfig.base, "large": ModelConfig.large,
                  "vggt_1b": VGGTConfig.vggt_1b, "vggt_tiny": VGGTConfig.tiny,
                  "fast3r_vitl_512": Fast3RConfig.fast3r_vitl_512,
                  "fast3r_tiny": Fast3RConfig.tiny}


def model_preset(name: str):
    """The `ModelConfig` (MASt3R), `VGGTConfig` or `Fast3RConfig` of a
    preset name."""
    return _MODEL_PRESETS[name]()


@dataclass(frozen=True)
class MatchingConfig:
    """Reciprocal nearest-neighbor descriptor matching (SURVEY §2b
    "Pairwise inference" row; reference subsample: reconstruct.py:80)."""

    subsample: int = 8              # match every 8th pixel
    # padded per-pair correspondence capacity; (H/sub)*(W/sub) upper bound is
    # applied automatically, this is an additional cap for memory.
    max_corres_per_pair: int = 4096
    # canonical depth aggregation: 'avg-angle' (reference default,
    # reconstruct.py:101-102) or 'conf' (plain confidence weighting)
    canonical_mode: str = "avg-angle"
    # pixel-accurate match refinement + core-cell anchoring (the
    # reference's operative matcher is full-resolution fast_reciprocal_NNs
    # whose matches sparse_ga anchors to the core grid — call-site
    # reconstruct.py:380). Grid-only matching snaps endpoints by up to
    # subsample/2 px; refinement cuts that to 0.5 px (ops.matching
    # .refine_matches). On by default, like the reference.
    anchor_refine: bool = True


@dataclass(frozen=True)
class GAConfig:
    """Sparse global alignment (reference: reconstruct.py:60-69,116-127)."""

    lr1: float = 0.07               # coarse phase LR     (reconstruct.py:61)
    niter1: int = 500               # coarse iters        (reconstruct.py:62)
    lr2: float = 0.014              # fine phase LR       (reconstruct.py:63)
    niter2: int = 200               # fine iters          (reconstruct.py:64)
    gamma1: float = 1.1             # coarse robust gamma (reconstruct.py:118)
    gamma2: float = 0.4             # fine robust gamma   (reconstruct.py:119)
    gamma_d: float = 1.1            # dust3r-fallback gamma (reconstruct.py:120)
    opt_pp: bool = True
    opt_depth: bool = False         # reference passes opt_depth=False (:66)
    matching_conf_thr: float = 5.0  # (reconstruct.py:67)
    loss_dust3r_w: float = 0.01     # regression fallback weight (:126)
    shared_intrinsics: bool = False
    adam_b1: float = 0.9
    adam_b2: float = 0.9            # reference uses betas=(0.9, 0.9) (:373)
    # GA steps per host read: per jitted device call in the JAX package,
    # per run of replays of the captured step in the port. Any value gives
    # the same result.
    jit_chunk: int = 50
    lr_end: float = 0.0
    depth_mode: str = "add"
    # log-space core-depth parameterization (reference reconstruct.py:122
    # `exp_depth=False`, use :249-250, init :274-275): params hold
    # log(depth); positivity is enforced by construction. Off by default
    # upstream and here.
    exp_depth: bool = False
    # post-GA Levenberg–Marquardt refinement of absolute poses (+focal)
    # over the 3D-3D correspondences (alignment/lm.py; the scale path the
    # Adam GA's chained parameterization cannot serve — SURVEY §7.2 layer 5)
    refine_lm: bool = False
    lm_iters: int = 12
    lm_damping: float = 1e-3
    # 'lm' = dense two-view normal equations (alignment/lm.py);
    # 'schur' = latent-track Schur-complement reduction (alignment/schur.py
    # — the keyframe-scale path, BASELINE configs 4-5)
    lm_mode: str = "lm"
    lm_max_obs: int = 8             # schur: observations per sub-track
    # focal clamping (reconstruct.py:204-206)
    min_focal_factor: float = 0.25
    max_focal_factor: float = 10.0
    # spectral low-rank depth re-parameterization (reference
    # reconstruct.py:123,251-252,270-273 `lora_depth`; off by default there
    # too). k/gamma/min_norm match the reference's commented defaults
    # dict(k=96, gamma=15, min_norm=.5); alignment/spectral.py builds the
    # basis, the GA then optimizes k coefficients per image.
    lora_depth: bool = False
    lora_k: int = 96
    lora_gamma: float = 15.0
    lora_min_norm: float = 0.5


@dataclass(frozen=True)
class SplatConfig:
    """3D Gaussian Splatting (reference: starster/gs.py)."""

    init_scale: float = 3e-3        # gs.py:14
    lr: float = 1e-3                # gs.py:14,37
    sh_degree: int = 1              # gs.py:86
    sh_bands: int = 24              # "shN" rest bands (gs.py:27)
    loss_ssim_fac: float = 0.2      # gs.py:101
    loss_opacity_fac: float = 0.01  # gs.py:102
    loss_scale_fac: float = 0.01    # gs.py:103
    # geometry prior: penalize squared drift of means from their SEED
    # positions (the metric reconstruction's points). 0 = off (reference
    # behavior — it has no such prior). Sparse-view captures overfit the
    # train views with floaters (Gaussians drifting far off the surface,
    # p95 drift >2 world units observed on the 5-view e2e scene); the
    # reconstruction is a depth prior the loss should be allowed to use.
    loss_anchor_fac: float = 0.0
    tile_size: int = 16             # gsplat-style 16x16 tiles
    # static per-Gaussian tile-entry budget: each Gaussian's projected bbox
    # is enumerated exactly up to this many tiles (overflow is COUNTED in
    # info["n_tiles_clipped"], never silent)
    max_tiles_per_gaussian: int = 16
    max_per_tile: int = 1024        # per-tile entry capacity (overflow
                                    # counted in info["tile_overflow"])
    chunk: int = 128                # compositing chunk length
    # pick the smallest power-of-2 (max_tiles_per_gaussian, max_per_tile)
    # buckets the SCENE actually needs at train time (measured from the
    # projected bbox areas / tile occupancy, growing — with a recompile —
    # if the scene outgrows them; the configured values above become
    # ceilings). The binning sorts and the gather backward scale with
    # these budgets. Used by training, which the port has not reached yet.
    auto_budget: bool = True
    # recompute tile binning (the two sorts) every N training steps.
    # Cameras are fixed during splat training and means move ~lr per step,
    # so the tile assignment drifts slowly; projection and all gradients
    # stay exact regardless — only the binning indices age. 1 = rebin every
    # step (gsplat-exact). The training loop always rebins right after an
    # MCMC refine (relocated Gaussians jump).
    rebin_every: int = 1
    # MCMC relocation + growth strategy (gsplat MCMCStrategy analog,
    # SURVEY §2b; defaults = gsplat MCMCStrategy defaults)
    cap_max: int = 1_000_000        # Gaussian pool growth ceiling
    mcmc_min_opacity: float = 0.005
    mcmc_noise_lr: float = 5e5
    mcmc_refine_every: int = 100
    mcmc_refine_start: int = 500
    mcmc_refine_stop: int = 25_000
    mcmc_grow_factor: float = 1.05  # +5% alive slots per refine
    # default Gaussian pool over-allocation: init_3dgs reserves
    # min(cap_max, pool_headroom * N) slots so MCMC growth can activate
    # them without reallocation (gsplat grows toward cap_max by default —
    # reference starster/gs.py:43-45). 0 disables headroom (pool == N,
    # growth inert).
    pool_headroom: float = 2.0
    # per-parameter learning-rate overrides (None = cfg.lr — the
    # reference's single Adam lr on every tensor, gs.py:37). Standard 3DGS
    # practice separates these by ~100x (means ~1.6e-4*extent, opacities
    # ~5e-2, scales ~5e-3, SH ~2.5e-3); the uniform reference lr makes
    # positions jitter at world scale and colors adapt too slowly. The
    # optimizer state layout is identical either way (splat/train.py
    # make_optimizer), so MCMC moment resets and checkpoints are
    # unaffected.
    lr_means: Optional[float] = None
    lr_quats: Optional[float] = None
    lr_scales: Optional[float] = None
    lr_opacities: Optional[float] = None
    lr_sh: Optional[float] = None
    # compat quirks (SURVEY §2a quirk list — reproduce reference by default)
    compat_inverted_sh: bool = True     # SH init is (1 - color) in all bands
    compat_raw_activations: bool = True # raw opacity/scale to rasterizer
    camera_batch: int = 0           # 0 = all cameras per step (reference)


@dataclass(frozen=True)
class SceneConfig:
    conf_thres: float = 1.5         # dense point confidence (scene.py:101)
    cache_dir: Optional[str] = None


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for pjit/shard_map distribution (SURVEY §2c)."""

    data_axis: str = "data"         # pair-parallel inference, camera batches
    model_axis: str = "model"       # optional tensor parallelism
    gauss_axis: str = "gauss"       # Gaussian shards in splat training
    data: int = 0                   # 0 = use all devices on data axis
    model: int = 1


@dataclass(frozen=True)
class Config:
    image: ImageConfig = field(default_factory=ImageConfig)
    model: ModelConfig = field(default_factory=ModelConfig.tiny)
    matching: MatchingConfig = field(default_factory=MatchingConfig)
    ga: GAConfig = field(default_factory=GAConfig)
    splat: SplatConfig = field(default_factory=SplatConfig)
    scene: SceneConfig = field(default_factory=SceneConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    seed: int = 0

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config() -> Config:
    return Config()
