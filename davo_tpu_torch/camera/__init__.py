from .calibration import (
    BasinScoreConfig,
    CalibrationParameters,
    basin_score,
    calibration_error,
    calibration_residuals,
    get_camera_relative_points,
    num_calibration_parameters,
    pack_calibration_parameters,
    unpack_calibration_parameters,
)
from .calibration_fast import (
    calibration_error_channel_major,
    calibration_error_fast,
    first_quadrant_atan2_poly,
)

__all__ = [
    "BasinScoreConfig",
    "CalibrationParameters",
    "basin_score",
    "calibration_error",
    "calibration_residuals",
    "get_camera_relative_points",
    "num_calibration_parameters",
    "pack_calibration_parameters",
    "unpack_calibration_parameters",
    "calibration_error_channel_major",
    "calibration_error_fast",
    "first_quadrant_atan2_poly",
]
