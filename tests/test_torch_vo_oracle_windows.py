"""The oracle-prior windowed VO (``train/vo_eval.py::solve_windowed_vo``
and ``evaluate_vo``): the port against the JAX package in float64, the
odometry priors' draws (and the sequence's) injected from the JAX key.

The JAX tests' configuration: 9 frames of 24 points, windows of 3
chained by one frame, each solved by the Schur BA from its noisy priors.
Poses are compared as rotation matrices and translations; tolerance 1e-7
(LM decisions on converged iterates, rounding compounded).
"""

import jax
import numpy as np

from tests.test_torch_vo_incremental import J, T, _assert_poses_close, _ate, _jax_trajectory_draws, _port_config, _t
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def _prior_draws(key, frames, points):
    """``solve_windowed_vo``'s prior draws, key for key."""
    k1, k2 = jax.random.split(key)
    return dict(poses=_t(np.asarray(jax.random.normal(k1, (frames - 1, 6)))),
                points=_t(np.asarray(jax.random.normal(k2, (points, 3)))))


def test_solve_windowed_vo_with_injected_priors_matches_jax():
    """The JAX test's configuration (9 frames of 24 points, windows of 3
    chained by one frame), the priors' draws of the same key."""
    j_cfg = J.TrajectoryConfig(num_frames=9, num_points=24, window=3)
    key = jax.random.key(36)
    poses, points, pixels, vis = J.generate_trajectory(key, j_cfg)
    k = jax.random.fold_in(key, 1)
    expected = J.solve_windowed_vo(poses, points, pixels, vis, j_cfg, k)
    got = T.solve_windowed_vo(_t(poses), _t(points), _t(pixels), _t(vis), _port_config(j_cfg),
                              noise=_prior_draws(k, 9, 24))
    _assert_poses_close(got, expected, 1e-7)
    assert _ate(got, poses) < 0.01


def test_evaluate_vo_from_jax_draws_matches_jax():
    j_cfg = J.TrajectoryConfig(num_frames=9, num_points=24, window=3)
    key = jax.random.key(37)
    expected = J.evaluate_vo(key, j_cfg)
    k_scene, k_solve = jax.random.split(key)
    got = T.evaluate_vo(None, _port_config(j_cfg), device="cpu",
                        noise=dict(trajectory=_jax_trajectory_draws(k_scene, j_cfg),
                                   priors=_prior_draws(k_solve, 9, 24)))
    for name in ("rmse", "mean", "median", "max"):
        assert abs(float(got[name]) - float(expected[name])) <= 1e-7, name
    assert float(got["rmse"]) < 0.01
