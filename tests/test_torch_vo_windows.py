"""Windowed learned VO (``train/vo_eval.py``, ``pipeline="windows"``): the
port against the JAX package in float64.

Stitching is held on window poses the JAX package's helpers make (the
exact window-relative poses of a JAX-drawn orbit at a random gauge scale
a window, optionally perturbed, and ``tests/train/test_robust_stitch.py``'s
catastrophic window).  The window solves are held with truth-vector
guesses (each window's truth at its own gauge scale, as
``tests/train/test_vo_eval.py`` builds them) and with a tiny transformer
head whose weights ``state_dict_to_flax`` carries across (2 restarts, 10
BFGS iterations; the JAX side's fused objective is its Pallas kernel's
function, the plain version of the port's K2).  The port stacks every
window on the batch axis in one guess call; JAX calls once a window, so
each comparison is also the stacked call against the per-window loop,
and one test holds the port's stacked call against its own loop.  Poses
are compared as rotation matrices and translations.

Tolerances: window starts exactly; stitching 1e-10 (the JAX package's
lstsq is SVD-based, the port's QR); truth-guess windows 1e-9; the tiny
network's windows and the slice 1e-6 (10 iterations of line search on
each side, rounding compounded); the stacked call against the port's
own loop 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vo_incremental import J, T, _assert_poses_close, _ate, _jax_trajectory_draws, _port_config, _t
from tests.torch_port_helpers import torch_single_thread  # noqa: F401
from tests.train.test_robust_stitch import _exact_window_poses

# one layout for every case (the JAX package runs eagerly here and
# compiles each primitive once a shape): the catastrophic-window test's 14
# frames, windows of 4 at stride 1
POINTS, FRAMES = 8, 14


@pytest.mark.parametrize(
    "frames,window,stride", [(16, 4, 2), (16, 4, 1), (9, 4, 2), (14, 4, 1), (12, 5, 3), (4, 4, 2), (10, 3, 1)]
)
def test_window_starts_match_jax(frames, window, stride):
    assert T._window_starts(frames, window, stride) == J._window_starts(frames, window, stride)


def _windows(seed, frames, stride, noise=0.0):
    """A JAX orbit (16 points) and its exact window-relative poses (a
    random gauge scale a window), each non-anchor row moved by ``noise``
    times a normal from numpy's default_rng(seed)."""
    cfg = J.TrajectoryConfig(num_frames=frames, num_points=16, window=4, stride=stride)
    key = jax.random.key(seed)
    poses = J.generate_trajectory(key, cfg)[0]
    starts = J._window_starts(frames, 4, stride)
    window_poses = np.stack([np.asarray(w) for w in _exact_window_poses(poses, starts, 4, key)])
    if noise:
        window_poses[:, 1:] += noise * np.random.default_rng(seed).standard_normal(window_poses[:, 1:].shape)
    return poses, starts, window_poses


def _jax_stitch(stitch, starts, window_poses, frames):
    """The JAX package's stitch, under the matmul precision its pipeline
    sets (so that the primitives it compiles are shared with the
    pipeline's calls)."""
    window_poses = [jnp.asarray(w) for w in window_poses]
    with jax.default_matmul_precision("highest"):
        if stitch == "chain":
            return J._stitch_chain(starts, window_poses, frames)
        return J.stitch_windows_global(starts, window_poses, frames, robust=stitch == "robust")


@pytest.mark.parametrize("stitch", ["chain", "global", "robust"])
@pytest.mark.parametrize("noise", [0.0, 0.02], ids=["exact", "noisy"])
def test_stitching_matches_jax(stitch, noise):
    poses, starts, window_poses = _windows(5, FRAMES, 1, noise)
    expected = _jax_stitch(stitch, starts, window_poses, FRAMES)
    got = T.stitch_windows(starts, _t(window_poses), FRAMES, stitch)
    _assert_poses_close(got, expected, 1e-10)
    if not noise:
        assert _ate(got, poses) < 1e-4


def test_robust_stitch_confines_catastrophic_window():
    """``tests/train/test_robust_stitch.py``'s catastrophic window (one
    middle window moved by ~60 degrees and a wrong translation, stride 1):
    plain and robust stitching agree with the JAX package's, and the
    robust one confines the damage as the JAX test asserts."""
    poses, starts, window_poses = _windows(11, FRAMES, 1)
    bad = len(starts) // 2
    window_poses[bad, 1:] += np.asarray([0.7, -0.8, 0.5, 2.0, -1.5, 1.0])
    results = {}
    for stitch in ("global", "robust"):
        expected = _jax_stitch(stitch, starts, window_poses, FRAMES)
        results[stitch] = T.stitch_windows(starts, _t(window_poses), FRAMES, stitch)
        _assert_poses_close(results[stitch], expected, 1e-10)
    ate_plain, ate_robust = _ate(results["global"], poses), _ate(results["robust"], poses)
    assert ate_robust < 0.5 * ate_plain and ate_robust < 0.2, (ate_robust, ate_plain)


def test_stitch_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown stitch mode"):
        T.stitch_windows([0], torch.zeros(1, 4, 6, dtype=torch.float64), 4, "median")


# ---------------------------------------------------------- window solves ----


def _case(seed):
    j_cfg = J.TrajectoryConfig(num_frames=FRAMES, num_points=POINTS, window=4, stride=1)
    key = jax.random.key(seed)
    poses, points, pixels, vis = J.generate_trajectory(key, j_cfg)
    return j_cfg, key, poses, points, pixels, vis


def _oracle_guesses(poses, points, pixels, cfg):
    """JAX and port guess functions giving each window its truth vector at
    the gauge scale ``1 + 0.4 (i + 1)`` of window ``i`` (the JAX test's
    scale of the i-th call): the JAX one a window a call, the port one
    rows in, rows out."""
    from davo_tpu_torch.camera import CalibrationParameters, pack_calibration_parameters

    w, f = cfg.window, cfg.focal_length
    starts = J._window_starts(cfg.num_frames, w, cfg.stride or w - 2)
    p, poses, points = np.asarray(pixels), _t(poses), _t(points)
    vectors = {}
    for i, s in enumerate(starts):
        rel = T._to_window_frame(poses[s: s + w], poses[s])
        scale = 1.0 + 0.4 * (i + 1)
        world = points @ T.so3_rotation_matrix(poses[s, 0:3]).T + poses[s, 3:6]
        vectors[s] = pack_calibration_parameters(CalibrationParameters(
            intrinsics=torch.tensor([f - 1.0 if f >= 1.0 else np.log(f), 0.0, 0.0], dtype=torch.float64).reshape(1, 1, 3),
            world_points=(scale * world).reshape(1, -1, 3),
            camera_translations=(scale * rel[1:, 3:6]).reshape(w - 1, 1, 3),
            camera_rotations=rel[1:, 0:3].reshape(w - 1, 1, 3),
        )).reshape(-1).numpy()

    def start_of(w_pix):
        return next(s for s in starts if np.allclose(p[s: s + cfg.window], w_pix, rtol=0, atol=1e-9))

    def j_guess(pw, vw):
        return jnp.asarray(vectors[start_of(np.asarray(pw)[0])])[None]

    def t_guess(pw, vw):
        return torch.stack([_t(vectors[start_of(row)]) for row in pw.numpy()])

    return j_guess, t_guess


@pytest.mark.parametrize("stitch", ["chain", "global"])
def test_oracle_guess_windows_match_jax(stitch):
    """Truth windows at a different gauge scale each: stitched as the JAX
    package stitches them, and the trajectory recovered (the JAX test's
    bound, ATE < 1e-4)."""
    j_cfg, _, poses, points, pixels, vis = _case(21)
    j_guess, t_guess = _oracle_guesses(poses, points, pixels, j_cfg)
    expected = J.solve_windowed_vo_learned(j_guess, pixels, vis, j_cfg, stitch=stitch)
    got = T.solve_windowed_vo_learned(t_guess, _t(pixels), _t(vis), _port_config(j_cfg), stitch=stitch)
    _assert_poses_close(got, expected, 1e-9)
    assert _ate(got, poses) < 1e-4


@pytest.mark.parametrize(
    "overrides,match",
    [(dict(window=2), "window >= 3"), (dict(num_frames=3), "shorter than the window"),
     (dict(stride=3), "stride must be in")],
    ids=["window_2", "short", "stride_3"],
)
def test_window_layout_errors_match_jax(overrides, match):
    cfg = dict(num_frames=8, num_points=POINTS, window=4)
    cfg.update(overrides)
    pixels = torch.zeros(cfg["num_frames"], POINTS, 2, dtype=torch.float64)
    with pytest.raises(ValueError, match=match):
        J.solve_windowed_vo_learned(None, jnp.asarray(pixels.numpy()), jnp.ones((cfg["num_frames"], POINTS)),
                                    J.TrajectoryConfig(**cfg))
    with pytest.raises(ValueError, match=match):
        T.solve_windowed_vo_learned(None, pixels, torch.ones(cfg["num_frames"], POINTS), T.TrajectoryConfig(**cfg))


def test_evaluate_learned_vo_windows_from_jax_draws_matches_jax():
    """The slice as a whole (the JAX CLI's default recipe at a small
    size): the same sequence (JAX's draws), truth windows at a gauge scale
    each, the global stitch, one global refinement, the aligned ATE."""
    j_cfg = J.TrajectoryConfig(num_frames=FRAMES, num_points=POINTS, stride=1)
    key = jax.random.key(24)
    poses, points, pixels, _ = J.generate_trajectory(key, j_cfg)
    j_guess, t_guess = _oracle_guesses(poses, points, pixels, j_cfg)
    expected = J.evaluate_learned_vo(j_guess, key, j_cfg, refine=True)
    debug = {}
    got = T.evaluate_learned_vo(t_guess, None, _port_config(j_cfg), refine=True, device="cpu", debug_out=debug,
                                noise=dict(trajectory=_jax_trajectory_draws(key, j_cfg)))
    for name in ("rmse", "mean", "median", "max"):
        assert abs(float(got[name]) - float(expected[name])) <= 1e-9, name
    assert float(got["rmse"]) < 1e-4
    assert debug["window_starts"] == list(range(11)) and tuple(debug["window_poses"].shape) == (11, 4, 6)
