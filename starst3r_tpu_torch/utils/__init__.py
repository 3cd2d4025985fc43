from .device import resolve_device
from .se3 import (
    quat_normalize, quat_to_rotmat, rotmat_to_quat, quat_mul, quat_slerp,
    se3_from_quat_trans, se3_inverse, se3_compose, se3_apply,
    interp_se3, interp_se3_path,
)
from .schedules import (cosine_schedule, linear_schedule, gamma_loss,
                        meta_gamma_loss)
from .camera import (
    make_intrinsics, pixel_grid, unproject_depth, project_points, reproj2d,
    estimate_focal_from_pointmap,
)
from .metrics import MetricsLogger, Timer, timed
from .checkpoint import save_pytree, restore_pytree, tree_prefix_overwrite
from .compile_cache import enable_compilation_cache
