"""starst3r_tpu_torch — the PyTorch/CUDA port of starst3r_tpu.

images -> `Scene.add_images` (MASt3R-style pair inference, reciprocal
matching, canonical views, MST, condensation, two-phase global alignment,
optional LM/Schur polish) -> `Scene.init_3dgs` -> `Scene.run_3dgs_optim` ->
`Scene.render_3dgs[_original]`, with the tile compositing and its backward
in hand-written CUDA kernels for Hopper (`csrc/composite_fwd.cu`,
`csrc/composite_bwd.cu`); the command line is `python -m
starst3r_tpu_torch` (`cli.py`).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a GPU, asking for CUDA raises. The package imports
torch, numpy and PIL only, and nothing of JAX or of `starst3r_tpu`.
"""

from .version import __version__

from .config import (
    Config, ImageConfig, ModelConfig, MatchingConfig, GAConfig, SplatConfig,
    SceneConfig, MeshConfig, VGGTConfig, Fast3RConfig, default_config,
    model_preset,
)
from .imaging import (
    make_pair_indices, make_sliding_window_pairs, process_image, load_image,
    load_images, image_to_uint8,
)
from .utils import (interp_se3, interp_se3_path, se3_inverse, se3_apply,
                    quat_to_rotmat, rotmat_to_quat, save_pytree,
                    restore_pytree)
from .ops import ssim, psnr
from . import models
from .models import Fast3RModel, Mast3rModel, VGGTModel
from .reconstruct import reconstruct_scene
from .scene import Scene
from . import splat as gs  # reference-compat: `starster.gs`
from .splat import (init_3dgs, render_3dgs, render_3dgs_original,
                    run_3dgs_optim)
