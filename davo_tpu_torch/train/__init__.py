from .calibration import (
    CalibrationExperiment,
    TrainState,
    batch_generator,
    create_train_state,
    evaluate_calibration_ate,
    fit,
    fit_fov_curriculum,
    make_eval_step,
    make_train_step,
)
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .evaluation import (
    absolute_trajectory_error,
    camera_centers_from_poses,
    intrinsics_error,
    relative_pose_error,
    umeyama_alignment,
)
from .frontend import (
    FrontendExperiment,
    create_frontend_state,
    draw_render_noise,
    fit_frontend,
    frontend_eval_metrics,
    frontend_loss,
    make_frontend_train_step,
    render_scene_batch,
    save_frontend_checkpoint,
)
from .metrics import MetricsLogger
from .presets import PRESETS, get_preset
from .vo_eval import TrajectoryConfig, evaluate_vo, generate_trajectory, solve_windowed_vo

__all__ = [
    "CalibrationExperiment",
    "TrainState",
    "batch_generator",
    "create_train_state",
    "evaluate_calibration_ate",
    "fit",
    "fit_fov_curriculum",
    "make_eval_step",
    "make_train_step",
    "MetricsLogger",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
    "absolute_trajectory_error",
    "camera_centers_from_poses",
    "intrinsics_error",
    "relative_pose_error",
    "umeyama_alignment",
    "PRESETS",
    "get_preset",
    "FrontendExperiment",
    "create_frontend_state",
    "draw_render_noise",
    "fit_frontend",
    "make_frontend_train_step",
    "frontend_eval_metrics",
    "frontend_loss",
    "render_scene_batch",
    "save_frontend_checkpoint",
    "TrajectoryConfig",
    "generate_trajectory",
    "solve_windowed_vo",
    "evaluate_vo",
]
