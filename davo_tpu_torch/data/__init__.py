from .synthetic import (
    SceneConfig,
    draw_scene_noise,
    generate_batch,
    generate_scene,
    scenes_from_noise,
)

__all__ = [
    "SceneConfig",
    "draw_scene_noise",
    "generate_batch",
    "generate_scene",
    "scenes_from_noise",
]
