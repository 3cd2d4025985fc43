from .device import resolve_device
from .se3 import (
    quat_normalize, quat_to_rotmat, rotmat_to_quat, quat_slerp, se3_inverse,
    se3_apply, interp_se3, interp_se3_path,
)
from .schedules import cosine_schedule, meta_gamma_loss
from .camera import pixel_grid, estimate_focal_from_pointmap
from .metrics import MetricsLogger, Timer
