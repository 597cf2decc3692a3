from .frontend import (
    FrontendExperiment,
    draw_render_noise,
    frontend_eval_metrics,
    frontend_loss,
    render_scene_batch,
)

__all__ = [
    "FrontendExperiment",
    "draw_render_noise",
    "frontend_eval_metrics",
    "frontend_loss",
    "render_scene_batch",
]
