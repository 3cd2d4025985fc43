from .attention import fused_sdpa, rope_attention, sdpa
from .rope import apply_rope_2d, rope_2d_freqs
from .matching import (PairMatches, match_pair, reciprocal_nn, refine_matches,
                       subsample_grid_indices)
from .ssim import psnr, ssim, ssim_per_image
