from .mst import max_spanning_tree
from .canonical import CanonicalView, build_canonical_views, compute_anchors
from .condense import CondensedData, condense
from .ga import (GAParams, GAState, GAResult, init_params, make_K_cam_depth,
                 make_state, run_global_alignment)
