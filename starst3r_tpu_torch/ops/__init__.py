from .attention import sdpa
from .rope import apply_rope_2d, rope_2d_freqs
from .matching import (PairMatches, match_pair, reciprocal_nn, refine_matches,
                       subsample_grid_indices)
