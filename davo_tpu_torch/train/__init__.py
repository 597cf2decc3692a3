from .calibration import (
    CalibrationExperiment,
    batch_generator,
    evaluate_calibration_ate,
    make_eval_step,
)
from .checkpoint import latest_step, restore_checkpoint
from .evaluation import (
    absolute_trajectory_error,
    camera_centers_from_poses,
    intrinsics_error,
    relative_pose_error,
    umeyama_alignment,
)
from .frontend import (
    FrontendExperiment,
    draw_render_noise,
    frontend_eval_metrics,
    frontend_loss,
    render_scene_batch,
)

from .presets import PRESETS, get_preset

__all__ = [
    "CalibrationExperiment",
    "batch_generator",
    "evaluate_calibration_ate",
    "make_eval_step",
    "latest_step",
    "restore_checkpoint",
    "absolute_trajectory_error",
    "camera_centers_from_poses",
    "intrinsics_error",
    "relative_pose_error",
    "umeyama_alignment",
    "PRESETS",
    "get_preset",
    "FrontendExperiment",
    "draw_render_noise",
    "frontend_eval_metrics",
    "frontend_loss",
    "render_scene_batch",
]
