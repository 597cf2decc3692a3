"""The learned VO along a trajectory file
(``train/vo_eval.py::evaluate_vo_sequence_file`` with ``guess_fn``): the
port against the JAX package in float64, the JAX key's draws injected.

The windows pipeline along ``tests/fixtures/kitti_mini_00.txt`` (5
windows of 4, the global stitch) with the tiny transformer head of
``test_torch_vo_window_network.py`` (2 restarts, 10 BFGS iterations), on
the synthesised observations and end to end from frames rendered along
the file at 96 px through the front end (``frontend_v4``, ``eval-seq``'s
gates).  Tolerance: the ATE and RPE 1e-6 (10 BFGS iterations a window,
rounding compounded).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from davo_tpu.data.rendering import RenderConfig as JRenderConfig
from davo_tpu.data.sequences import load_sequence as j_load_sequence
from davo_tpu_torch.data import RenderConfig
from tests.test_torch_eval_seq import KITTI, POINTS, _metrics_close, _observation_draws
from tests.test_torch_vo_incremental import J, T, _jax_render_draws
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


@pytest.fixture(scope="module")
def networks():
    """The tiny transformer heads (2 restarts, 10 iterations), started
    from the KITTI file's first window's truth (24 landmarks' first 8)."""
    import davo_tpu.models.calibration_network as j_network_module
    from tests.test_torch_calibration_network import _kernel_function_objective
    from tests.test_torch_vo_accumulator import _truth_vector
    from tests.test_torch_vo_window_network import _tiny_pair

    poses = j_load_sequence(KITTI, "kitti").poses
    points = J.observations_for_poses(poses, jnp.asarray([1.4, 0.0, 0.0]), jax.random.key(0), num_points=POINTS)[0]
    cfg = J.TrajectoryConfig(num_frames=12, num_points=POINTS, window=4)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
        yield _tiny_pair(_truth_vector(poses, points, cfg))


def test_learned_sequence_file_matches_jax(networks):
    """The learned windows pipeline on the synthesised observations along
    the KITTI file (5 windows of 4, the global stitch)."""
    j_guess, t_guess = networks
    key = jax.random.key(43)
    config = J.TrajectoryConfig(window=4)
    expected = J.evaluate_vo_sequence_file(KITTI, format="kitti", config=config, key=key, num_points=POINTS,
                                           guess_fn=j_guess)
    got = T.evaluate_vo_sequence_file(
        KITTI, format="kitti", config=T.TrajectoryConfig(window=4, dtype=torch.float64), num_points=POINTS,
        device="cpu", guess_fn=t_guess, noise=dict(observations=_observation_draws(jax.random.split(key)[0], POINTS)),
    )
    _metrics_close(got, expected, 1e-6)


def test_learned_sequence_file_from_rendered_frames_matches_jax(networks):
    """End to end from pixels along the KITTI file: frames rendered at 96
    px (the JAX key's draws), every window's matches from the front end
    (``frontend_v4``, ``eval-seq``'s gates), the tiny network's window
    solves, the global stitch."""
    from davo_tpu.models.vo_frontend import VOFrontend as JVOFrontend
    from davo_tpu_torch.models import FRONTEND_V4, load_frontend, load_frontend_npz

    gates = dict(nms_radius=0.1, centroid_refine_iters=2, snap_radius=0.08, cycle_threshold=0.08, quality_bonus=10.0,
                 score_threshold=0.5)
    j_guess, t_guess = networks
    variables = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), load_frontend_npz(FRONTEND_V4))
    j_frontend = JVOFrontend(**gates)

    @jax.jit
    def j_frontend_fn(images):
        out = j_frontend.apply(variables, images)
        return out.matches, out.match_visibility

    frontend, _ = load_frontend(device="cpu", dtype=torch.float64, **gates)

    def t_frontend_fn(images):
        out = frontend(images)
        return out.matches, out.match_visibility

    key = jax.random.key(44)
    j_render = JRenderConfig(image_size=96, dtype=jnp.float64)
    expected = J.evaluate_vo_sequence_file(KITTI, format="kitti", config=J.TrajectoryConfig(window=4), key=key,
                                           num_points=POINTS, guess_fn=j_guess, frontend_fn=j_frontend_fn,
                                           render_config=j_render)
    got = T.evaluate_vo_sequence_file(
        KITTI, format="kitti", config=T.TrajectoryConfig(window=4, dtype=torch.float64), num_points=POINTS,
        device="cpu", guess_fn=t_guess, frontend_fn=t_frontend_fn,
        render_config=RenderConfig(image_size=96, dtype=torch.float64),
        noise=dict(observations=_observation_draws(jax.random.split(key)[0], POINTS),
                   render=_jax_render_draws(jax.random.fold_in(key, 11), 12, POINTS, j_render)),
    )
    _metrics_close(got, expected, 1e-6)
