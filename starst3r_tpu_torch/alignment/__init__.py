from .mst import max_spanning_tree
from .canonical import CanonicalView, build_canonical_views, compute_anchors
from .condense import CondensedData, condense
from .ga import (GAParams, GAState, GAResult, init_params, make_K_cam_depth,
                 make_state, run_global_alignment)
from .lm import LMState, chain_to_absolute, lm_refine
from .schur import Tracks, build_tracks, schur_refine
