"""Trajectory refinement and the oracle windowed VO (``train/vo_eval.py``):
the port against the JAX package in float64, with JAX's draws injected.

``_rescale_segments``; ``refine_trajectory_multistart`` (the JAX key's
normal coefficients injected, hypotheses refined one after another in the
port where JAX vmaps them); ``refine_trajectory_host_f64`` (float64 on
the estimates' device in the port, on the host CPU in JAX);
``correct_scale_drift`` (BFGS over per-segment log-scales, autograd
through the DLT triangulation against ``jax.grad``).  Each case is a
JAX-drawn orbit deformed as the JAX package's own tests deform it (the
oracle windowed VO is in ``test_torch_vo_oracle_windows.py``).  Poses are
compared as rotation matrices and translations.

Tolerances: the rescale 1e-12; the polish 1e-10 in float64 and 1e-6 for
the float32 it returns (one rounding); the multistart and scale-drift
solves 1e-7 (LM or line-search decisions on converged iterates, rounding
compounded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vo_incremental import J, T, _assert_poses_close, _ate, _t
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

FRAMES, POINTS = 10, 16


def _orbit(seed, frames=FRAMES, points=POINTS):
    j_cfg = J.TrajectoryConfig(num_frames=frames, num_points=points)
    key = jax.random.key(seed)
    return (j_cfg, key) + tuple(J.generate_trajectory(key, j_cfg))


def _intrinsics(cfg):
    return jnp.asarray([cfg.focal_length, 0.0, 0.0])


def test_rescale_segments_matches_jax():
    _, _, poses, _, _, _ = _orbit(31)
    log_s = 0.3 * np.random.default_rng(0).standard_normal((3, FRAMES - 1))
    for row in log_s:
        np.testing.assert_allclose(to_numpy(T._rescale_segments(_t(poses), _t(row))),
                                   np.asarray(J._rescale_segments(poses, jnp.asarray(row))), rtol=0, atol=1e-12)
    batched = T._rescale_segments(_t(poses), _t(log_s))
    assert tuple(batched.shape) == (3, FRAMES, 6)
    np.testing.assert_allclose(to_numpy(batched[1]), to_numpy(T._rescale_segments(_t(poses), _t(log_s[1]))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(to_numpy(T._rescale_segments(_t(poses), torch.zeros(FRAMES - 1, dtype=torch.float64))),
                               np.asarray(poses), rtol=0, atol=1e-12)


def test_multistart_with_injected_coefficients_matches_jax():
    """The JAX test's low-frequency scale deformation at 0.3 (its 0.5
    drives the LM through states whose reduced systems are singular, where
    the two packages' solves part after two iterations), 4 hypotheses
    (sigma 0.2), 2 rounds of triangulation and BA each: the chosen
    hypothesis's poses agree, and it improves on the drifted start."""
    j_cfg, key, poses, _, pixels, vis = _orbit(32, frames=12, points=8)
    seg = jnp.arange(11, dtype=poses.dtype)
    drifted = J._rescale_segments(poses, 0.3 * jnp.cos(jnp.pi * (seg + 0.5) / 11.0))
    k_hyp = jax.random.fold_in(key, 11)
    expected = J.refine_trajectory_multistart(drifted, _intrinsics(j_cfg), pixels, vis, k_hyp, num_hypotheses=4,
                                              sigma=0.2)
    coefficients = _t(np.asarray(jax.random.normal(k_hyp, (3, 4), poses.dtype)))
    got = T.refine_trajectory_multistart(_t(drifted), _t(_intrinsics(j_cfg)), _t(pixels), _t(vis), num_hypotheses=4,
                                         sigma=0.2, coefficients=coefficients)
    _assert_poses_close(got, expected, 1e-7)
    assert _ate(got, poses) < 0.25 * _ate(drifted, poses)


def test_multistart_draws_from_the_generator():
    j_cfg, _, poses, _, pixels, vis = _orbit(33, frames=6, points=8)
    args = (_t(poses), _t(_intrinsics(j_cfg)), _t(pixels), _t(vis))
    kwargs = dict(num_hypotheses=3, solver=T.SchurConfig(iterations=2, damping=1e-3), rounds=1)
    drawn = T.refine_trajectory_multistart(*args, torch.Generator().manual_seed(5), **kwargs)
    coefficients = torch.randn((2, 4), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    injected = T.refine_trajectory_multistart(*args, coefficients=coefficients, **kwargs)
    np.testing.assert_array_equal(to_numpy(drawn), to_numpy(injected))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_host_polish_matches_jax(dtype):
    """The JAX test's noisy start (0.05 on every pose but frame 0's),
    polished in float64 from inputs of ``dtype`` and handed back in it."""
    j_cfg, key, poses, _, pixels, vis = _orbit(34)
    noisy = poses.at[1:].add(0.05 * jax.random.normal(jax.random.fold_in(key, 9), (FRAMES - 1, 6)))
    j_dtype, t_dtype = getattr(jnp, dtype), getattr(torch, dtype)
    expected = J.refine_trajectory_host_f64(noisy.astype(j_dtype), _intrinsics(j_cfg).astype(j_dtype),
                                            pixels.astype(j_dtype), vis)
    got = T.refine_trajectory_host_f64(_t(noisy).to(t_dtype), _t(_intrinsics(j_cfg)).to(t_dtype),
                                       _t(pixels).to(t_dtype), _t(vis))
    assert got.dtype == t_dtype
    _assert_poses_close(got.double(), np.asarray(expected, np.float64), 1e-6 if dtype == "float32" else 1e-10)
    assert _ate(got.double(), poses) < 1e-4


def test_correct_scale_drift_matches_jax():
    """The JAX test's compounding per-segment scale errors (12 frames, 16
    points): the same corrected poses, the rotations untouched, the ATE
    below the JAX test's bound."""
    j_cfg, key, poses, _, pixels, vis = _orbit(35, frames=12)
    rot = np.asarray(J.so3_rotation_matrix(poses[:, 0:3]))
    centres = -np.einsum("kji,kj->ki", rot, np.asarray(poses[:, 3:6]))
    seg_scale = 1.0 + 0.15 * np.asarray(jax.random.normal(jax.random.fold_in(key, 6), (11,)))
    bad_centres = centres[0] + np.concatenate([np.zeros((1, 3)), np.cumsum(seg_scale[:, None] * np.diff(centres, axis=0),
                                                                           axis=0)])
    bad = np.concatenate([np.asarray(poses[:, 0:3]), -np.einsum("kij,kj->ki", rot, bad_centres)], axis=-1)
    expected = J.correct_scale_drift(jnp.asarray(bad), _intrinsics(j_cfg), pixels, vis)
    got = T.correct_scale_drift(_t(bad), _t(_intrinsics(j_cfg)), _t(pixels), _t(vis))
    _assert_poses_close(got, expected, 1e-7)
    np.testing.assert_array_equal(to_numpy(got[:, 0:3]), bad[:, 0:3])
    assert _ate(got, poses) < 1e-3
