from .rendering import (
    RenderConfig,
    appearance_from_noise,
    draw_appearance_noise,
    draw_frame_noise,
    render_frame,
    render_views,
    render_views_nokey,
    sample_appearance,
)
from .sequences import (
    SequenceData,
    associate_timestamps,
    load_kitti_calib,
    load_kitti_trajectory,
    load_sequence,
    load_tum_intrinsics,
    load_tum_trajectory,
)
from .synthetic import (
    SceneConfig,
    draw_scene_noise,
    generate_batch,
    generate_scene,
    scenes_from_noise,
)
from .vo_windows import (
    VOWindowConfig,
    draw_window_noise,
    generate_vo_window_batch,
    windows_from_noise,
)

__all__ = [
    "RenderConfig",
    "appearance_from_noise",
    "draw_appearance_noise",
    "draw_frame_noise",
    "render_frame",
    "render_views",
    "render_views_nokey",
    "sample_appearance",
    "SequenceData",
    "associate_timestamps",
    "load_kitti_calib",
    "load_kitti_trajectory",
    "load_sequence",
    "load_tum_intrinsics",
    "load_tum_trajectory",
    "SceneConfig",
    "draw_scene_noise",
    "generate_batch",
    "generate_scene",
    "scenes_from_noise",
    "VOWindowConfig",
    "draw_window_noise",
    "generate_vo_window_batch",
    "windows_from_noise",
]
