"""The learned bootstrap of incremental VO and the slice as a whole: the
port against the JAX package in float64.

Truth-vector guesses (each window's own truth) exercise the bootstrap's
IRLS re-solves, the intrinsics unpacking and the choice among candidate
windows; a tiny converted guess network, whose output layer carries the
truth vector with its weights scaled to 1e-3 (the guess is the truth
moved by what every layer computes), exercises the network's eval solve
(the plain versions of K1 and K2 on the CPU) in the bootstrap.  The
sequences share one shape (6 frames of 8 points), as in
``test_torch_vo_accumulator.py``, whose helpers these tests use.

Tolerances: poses 1e-8 (rotation matrices, and translations relative to
their scale) and costs 1e-8 relative with truth guesses; 1e-6 with the
guess network (8 BFGS iterations on each side, rounding compounded).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vo_accumulator import (
    FRAMES,
    POINTS,
    _case,
    _clean_detections,
    _tiny_networks,
    _truth_guesses,
    _truth_vector,
)
from tests.test_torch_vo_incremental import J, T, _assert_poses_close, _ate, _jax_trajectory_draws, _port_config, _t
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def test_solve_learned_vo_incremental_truth_guess_matches_jax():
    """A truth-vector guess_fn on oracle tracks (no detections): the
    bootstrap's IRLS re-solves, the intrinsics unpacking, the accumulator
    and the final BA with the focal free."""
    j_cfg, poses, points, pixels, vis = _case(13)
    j_guess, t_guess = _truth_guesses(poses, points, pixels, j_cfg)
    expected = J.solve_learned_vo_incremental(j_guess, pixels, vis.astype(pixels.dtype), j_cfg)
    got = T.solve_learned_vo_incremental(t_guess, _t(pixels), _t(vis).double(), _port_config(j_cfg))
    _assert_poses_close(got, expected, 1e-8)
    assert _ate(got, poses) < 1e-4


def test_solve_learned_vo_incremental_bootstrap_selection_matches_jax():
    """Detections with 3 candidate bootstraps (np.linspace starts 0, 1, 2),
    truth guesses, ba_irls 1: every chain's cost, the chosen bootstrap and
    the poses agree."""
    j_cfg, poses, points, pixels, vis = _case(12)
    dets, scores = _clean_detections(pixels, vis)
    j_guess, t_guess = _truth_guesses(poses, points, pixels, j_cfg)
    visf = np.asarray(vis, np.float64)
    j_debug, t_debug = {}, {}
    expected = J.solve_learned_vo_incremental(
        j_guess, pixels, jnp.asarray(visf), j_cfg, detections=jnp.asarray(dets), det_scores=jnp.asarray(scores),
        ba_irls=1, debug_out=j_debug)
    got = T.solve_learned_vo_incremental(
        t_guess, _t(pixels), _t(visf), _port_config(j_cfg), detections=_t(dets), det_scores=_t(scores),
        ba_irls=1, debug_out=t_debug)
    assert sorted(t_debug["bootstrap_costs"]) == sorted(j_debug["bootstrap_costs"]) == [0, 1, 2]
    assert t_debug["chosen_bootstrap"] == j_debug["chosen_bootstrap"]
    for s, cost in j_debug["bootstrap_costs"].items():
        assert abs(t_debug["bootstrap_costs"][s] - cost) <= 1e-8 * max(1.0, abs(cost))
    _assert_poses_close(got, expected, 1e-8)


def test_solve_learned_vo_incremental_tiny_network_matches_jax(monkeypatch):
    """The tiny converted guess network on the detection branch (one
    bootstrap window, its guess and two IRLS re-solves through 8 BFGS
    iterations each): the bootstrap's cost and the poses agree."""
    j_cfg, poses, points, pixels, vis = _case(14)
    dets, scores = _clean_detections(pixels, vis, seed=9)
    j_guess, t_guess = _tiny_networks(monkeypatch, _truth_vector(poses, points, j_cfg))
    visf = np.asarray(vis, np.float64)
    j_debug, t_debug = {}, {}
    expected = J.solve_learned_vo_incremental(
        j_guess, pixels, jnp.asarray(visf), j_cfg, detections=jnp.asarray(dets), det_scores=jnp.asarray(scores),
        num_bootstraps=1, ba_irls=1, debug_out=j_debug)
    got = T.solve_learned_vo_incremental(
        t_guess, _t(pixels), _t(visf), _port_config(j_cfg), detections=_t(dets), det_scores=_t(scores),
        num_bootstraps=1, ba_irls=1, debug_out=t_debug)
    cost = j_debug["bootstrap_costs"][0]
    assert abs(t_debug["bootstrap_costs"][0] - cost) <= 1e-6 * max(1.0, abs(cost))
    _assert_poses_close(got, expected, 1e-6)


def test_evaluate_learned_vo_from_jax_draws_matches_jax(monkeypatch):
    """The slice as a whole on oracle matches: the same sequence (JAX's
    draws), the tiny converted network, the accumulator, a global
    refinement, the aligned ATE."""
    j_cfg = J.TrajectoryConfig(num_frames=FRAMES, num_points=POINTS)
    key = jax.random.key(15)
    poses, points, _, _ = J.generate_trajectory(key, j_cfg)
    j_guess, t_guess = _tiny_networks(monkeypatch, _truth_vector(poses, points, j_cfg))
    expected = J.evaluate_learned_vo(j_guess, key, j_cfg, pipeline="incremental", refine=True)
    got = T.evaluate_learned_vo(
        t_guess, None, _port_config(j_cfg), pipeline="incremental", refine=True, device="cpu",
        noise=dict(trajectory=_jax_trajectory_draws(key, j_cfg)),
    )
    for name in ("rmse", "mean", "median", "max"):
        assert abs(float(got[name]) - float(expected[name])) <= 1e-6 * max(1.0, float(expected[name])), name
    assert float(got["rmse"]) < 1e-3


def test_evaluate_learned_vo_refuses_what_is_not_ported():
    """The distributed refinement (``mesh=``) is refused before any work;
    an unknown pipeline or stitch mode is an error (the windows pipeline,
    multistart and the float64 polish run: ``test_torch_vo_windows.py``,
    ``test_torch_vo_refine.py``)."""
    cfg = T.TrajectoryConfig(num_frames=FRAMES, num_points=POINTS)
    with pytest.raises(NotImplementedError, match="item 9"):
        T.evaluate_learned_vo(None, torch.Generator(), cfg, device="cpu", refine=True, mesh=object())
    for kwargs, match in ((dict(pipeline="bundles"), "unknown pipeline"), (dict(stitch="median"), "unknown stitch")):
        with pytest.raises(ValueError, match=match):
            T.evaluate_learned_vo(None, torch.Generator(), cfg, device="cpu", **kwargs)
