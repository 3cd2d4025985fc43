from .cache import PairCache, content_key
from .ply import save_ply, load_ply
from .from_jax import (ga_params_from_jax, gaussians_from_jax,
                       gs_state_from_jax, mast3r_state_dict_from_jax)
