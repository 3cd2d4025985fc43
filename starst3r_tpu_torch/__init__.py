"""starst3r_tpu_torch — the PyTorch/CUDA port of starst3r_tpu.

The reconstruct-and-render path (README Quickstart without the 3DGS
optimisation): images -> `Scene.add_images` (MASt3R-style pair inference,
reciprocal matching, canonical views, MST, condensation, two-phase global
alignment) -> `Scene.init_3dgs` -> `Scene.render_3dgs[_original]`, with the
tile compositing in a hand-written CUDA kernel for Hopper
(`csrc/composite_fwd.cu`).

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a GPU, asking for CUDA raises. The package imports
torch, numpy and PIL only, and nothing of JAX or of `starst3r_tpu`.
"""

from .config import (
    Config, ImageConfig, ModelConfig, MatchingConfig, GAConfig, SplatConfig,
    SceneConfig, MeshConfig, default_config, model_preset,
)
from .imaging import (
    make_pair_indices, make_sliding_window_pairs, process_image, load_image,
    load_images,
)
from .utils import (interp_se3, interp_se3_path, se3_inverse, se3_apply,
                    quat_to_rotmat, rotmat_to_quat)
from .models import Mast3rModel
from .reconstruct import reconstruct_scene
from .scene import Scene
from . import splat as gs  # reference-compat: `starster.gs`
from .splat import init_3dgs, render_3dgs, render_3dgs_original
