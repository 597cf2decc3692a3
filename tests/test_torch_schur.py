"""The Schur bundle adjustment, the least-squares solver and the SO(3)
parameter Jacobian: the port against the JAX package on the same numpy
inputs, in float64.

Tolerances: the Jacobian 1e-12 (absolute; entries are O(1)), the small
SPD solve and the LM 1e-10 relative to the largest entry, the BA's
residuals, cost, one step and the solved problem 1e-9 (the reduced camera
system and its 3 x 3 point blocks are LU-solved and inverted by LAPACK on
both sides, in other orders).  Gauge dimensions must not move at all.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.geometry import rotate_vector_axis_angle as j_rotate
from davo_tpu.geometry import so3_parameter_jacobian as j_jacobian
from davo_tpu.parallel import BAObservations as JObs
from davo_tpu.parallel import BAProblem as JProblem
from davo_tpu.parallel import SchurConfig as JConfig
from davo_tpu.parallel import ba_cost as j_ba_cost
from davo_tpu.parallel import ba_residuals as j_ba_residuals
from davo_tpu.parallel import schur_ba_solve as j_schur_ba_solve
from davo_tpu.parallel import schur_normal_step as j_schur_normal_step
from davo_tpu.solve.least_squares import LMConfig as JLMConfig
from davo_tpu.solve.least_squares import levenberg_marquardt as j_levenberg_marquardt
from davo_tpu.solve.least_squares import spd_solve_small as j_spd_solve_small
from davo_tpu_torch.geometry import rotate_vector_axis_angle, so3_parameter_jacobian
from davo_tpu_torch.parallel import (
    BAObservations,
    BAProblem,
    SchurConfig,
    ba_cost,
    ba_residuals,
    default_gauge_masks,
    schur_ba_solve,
    schur_normal_step,
)
from davo_tpu_torch.solve import LMConfig, levenberg_marquardt, spd_solve_small
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

M, N = 4, 16


def _close(got, expected, tol):
    got, expected = to_numpy(got), np.asarray(expected)
    scale = max(1.0, float(np.max(np.abs(expected))))
    assert float(np.max(np.abs(got - expected))) <= tol * scale


# ------------------------------------------------------------- SO(3) ----


@pytest.mark.parametrize("angle_scale", [1.0, 3.0, 1e-2, 1e-5, 0.0], ids=["unit", "large", "small", "tiny", "zero"])
def test_so3_parameter_jacobian_matches_jax(angle_scale):
    """Every Taylor branch: |w|^2 below 0.05^2 (three ratios) and below
    0.25^2 (sin_cubed_sq), and w = 0 exactly (-[v]_x)."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3))
    w = angle_scale * rng.normal(size=(64, 3))
    w[::7] *= 0.1  # spread the squared angle across the switch points
    got = so3_parameter_jacobian(torch.tensor(v), torch.tensor(w))
    expected = j_jacobian(jnp.asarray(v), jnp.asarray(w))
    _close(got, expected, 1e-12)
    assert np.all(np.isfinite(to_numpy(got)))


def test_so3_parameter_jacobian_is_the_derivative_of_the_rotation():
    """Against torch autodiff of the port's own rotation, at small and at
    ordinary angles (the autodiff route runs the ratios' Functions)."""
    rng = np.random.default_rng(1)
    v = torch.tensor(rng.normal(size=(6, 3)))
    w = torch.tensor(rng.normal(size=(6, 3)) * np.array([[1.0], [1e-3], [0.2], [2.0], [1e-6], [0.04]]))
    jac = torch.autograd.functional.jacobian(lambda ww: rotate_vector_axis_angle(v, ww), w)
    expected = torch.stack([jac[i, :, i, :] for i in range(6)])
    _close(so3_parameter_jacobian(v, w), expected, 1e-12)


# ---------------------------------------------------- least squares ----


@pytest.mark.parametrize("p", [6, 9])
def test_spd_solve_small_matches_jax(p):
    rng = np.random.default_rng(p)
    a = rng.normal(size=(32, p, p))
    # badly scaled SPD systems: the Jacobi scaling's case
    scale = np.exp(rng.uniform(-6, 6, size=(32, p)))
    spd = (a @ a.transpose(0, 2, 1) + 1e-3 * np.eye(p)) * scale[:, :, None] * scale[:, None, :]
    b = rng.normal(size=(32, p))
    got = spd_solve_small(torch.tensor(spd), torch.tensor(b))
    expected = np.asarray(j_spd_solve_small(jnp.asarray(spd), jnp.asarray(b)))
    np.testing.assert_allclose(to_numpy(got), expected, rtol=1e-10, atol=0)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", spd, to_numpy(got)), b, rtol=1e-6, atol=1e-6)


def _curve_problem():
    """Batched fits of ``y = a exp(b x) + c`` (3 parameters, 12 samples);
    element 2 starts at its exact solution, so its error is 0 and it is
    frozen from the first iteration."""
    x = np.linspace(-1.0, 1.0, 12)
    truth = np.array([[1.5, -0.7, 0.2], [0.4, 1.3, -1.0], [2.0, 0.5, 0.0]])
    y = truth[:, 0:1] * np.exp(truth[:, 1:2] * x) + truth[:, 2:3]
    start = truth + np.array([[0.5, 0.4, -0.3], [-0.2, -0.6, 0.5], [0.0, 0.0, 0.0]])
    return x, y, start


def _curve_fn(lib, x, y):
    def residual_and_jacobian(params):
        a, b, c = params[..., 0:1], params[..., 1:2], params[..., 2:3]
        e = lib.exp(b * x)
        res = a * e + c - y
        jac = lib.stack([e, a * x * e, lib.ones_like(e)], -1)
        return res, jac

    return residual_and_jacobian


@pytest.mark.parametrize("error_threshold", [0.0, 1e-20])
def test_levenberg_marquardt_matches_jax(error_threshold):
    x, y, start = _curve_problem()
    got = levenberg_marquardt(
        _curve_fn(torch, torch.tensor(x), torch.tensor(y)), torch.tensor(start),
        LMConfig(iterations=15, error_threshold=error_threshold),
    )
    expected = j_levenberg_marquardt(
        _curve_fn(jnp, jnp.asarray(x), jnp.asarray(y)), jnp.asarray(start),
        JLMConfig(iterations=15, error_threshold=error_threshold),
    )
    _close(got, expected, 1e-10)
    assert np.array_equal(to_numpy(got)[2], start[2])  # the frozen element never moves
    assert float(np.max(np.abs(to_numpy(got)[:2] - np.array([[1.5, -0.7, 0.2], [0.4, 1.3, -1.0]])))) < 1e-8


# -------------------------------------------------------- Schur BA ----


def _make_problem(rng, noise=0.0):
    """tests/parallel/test_schur.py's problem: 4 views of 16 points."""
    points = np.concatenate([rng.normal(size=(N, 2)) * 2.0, 8.0 + rng.normal(size=(N, 1))], axis=-1)
    poses = np.zeros((M, 6))
    poses[:, 0:3] = rng.normal(size=(M, 3)) * 0.05
    poses[:, 3:5] = rng.normal(size=(M, 2)) * 0.5
    poses[0] = 0.0  # gauge view
    intrinsics = np.array([1.4, 0.05, -0.05])
    rel = np.asarray(j_rotate(jnp.asarray(points)[None], jnp.asarray(poses)[:, None, 0:3])) + poses[:, None, 3:6]
    pixels = np.stack([1.4 * rel[..., 0] / rel[..., 2] + 0.05, 1.4 * rel[..., 1] / rel[..., 2] - 0.05], axis=-1)
    truth = (intrinsics, poses, points)
    start = truth
    if noise > 0.0:
        start = (
            intrinsics + noise * rng.normal(size=3),
            poses + np.concatenate([np.zeros((1, 6)), noise * rng.normal(size=(M - 1, 6))]),
            points + noise * rng.normal(size=(N, 3)),
        )
    return truth, start, (pixels, np.ones((M, N), bool))


def _pair(problem, obs):
    j = (JProblem(*map(jnp.asarray, problem)), JObs(*map(jnp.asarray, obs)))
    t = (BAProblem(*map(torch.tensor, problem)), BAObservations(*map(torch.tensor, obs)))
    return j, t


def _cost(problem, obs):
    return float(torch.sum(torch.square(ba_residuals(problem, obs))))


def test_residuals_and_cost_match_jax(rng):
    truth, start, obs = _make_problem(rng, noise=0.02)
    for problem in (truth, start):
        (jp, jo), (tp, to) = _pair(problem, obs)
        _close(ba_residuals(tp, to), j_ba_residuals(jp, jo), 1e-12)
        for loss in ("l2", "l1"):
            _close(ba_cost(tp, to, SchurConfig(loss=loss)), j_ba_cost(jp, jo, JConfig(loss=loss)), 1e-12)
    (_, _), (tp, to) = _pair(truth, obs)
    assert _cost(tp, to) < 1e-20  # zero residual at the truth


def test_one_step_matches_jax_and_decreases_cost(rng):
    _, start, obs = _make_problem(rng, noise=0.02)
    (jp, jo), (tp, to) = _pair(start, obs)
    stepped, cost = schur_normal_step(tp, to, SchurConfig(damping=1e-6))
    j_stepped, j_cost = j_schur_normal_step(jp, jo, JConfig(damping=1e-6))
    _close(cost, j_cost, 1e-12)
    for got, expected in zip(stepped, j_stepped):
        _close(got, expected, 1e-9)
    assert _cost(stepped, to) < _cost(tp, to)


def test_solve_matches_jax_and_converges(rng):
    _, start, obs = _make_problem(rng, noise=0.02)
    (jp, jo), (tp, to) = _pair(start, obs)
    solved = schur_ba_solve(tp, to, SchurConfig(iterations=15, damping=1e-4))
    expected = j_schur_ba_solve(jp, jo, JConfig(iterations=15, damping=1e-4))
    for got, exp in zip(solved, expected):
        _close(got, exp, 1e-9)
    assert _cost(solved, to) < 1e-10


def test_gauge_dimensions_do_not_move(rng):
    _, start, obs = _make_problem(rng, noise=0.02)
    (jp, jo), (tp, to) = _pair(start, obs)
    solved = schur_ba_solve(tp, to, SchurConfig(iterations=5))
    assert torch.equal(solved.poses[0], tp.poses[0])
    assert torch.equal(solved.points[0, 2], tp.points[0, 2])
    # custom masks (the accumulator's): intrinsics frozen, another gauge point
    intr_free, pose_free, point_free = default_gauge_masks(M, N)
    intr_free[:] = False
    point_free[0, 2], point_free[5, 2] = True, False
    masks = (intr_free, pose_free, point_free)
    solved = schur_ba_solve(tp, to, SchurConfig(iterations=5), gauge_masks=masks)
    expected = j_schur_ba_solve(jp, jo, JConfig(iterations=5), gauge_masks=tuple(jnp.asarray(to_numpy(x)) for x in masks))
    for got, exp in zip(solved, expected):
        _close(got, exp, 1e-9)
    assert torch.equal(solved.intrinsics, tp.intrinsics)
    assert torch.equal(solved.points[5, 2], tp.points[5, 2])


def test_l1_irls_matches_jax_and_resists_an_outlier(rng):
    _, start, (pixels, vis) = _make_problem(rng, noise=0.01)
    bad = pixels.copy()
    bad[1, 0] += 5.0
    (jp, jo), (tp, to) = _pair(start, (bad, vis))
    clean = BAObservations(torch.tensor(pixels), torch.tensor(vis))
    solved = {}
    for loss in ("l2", "l1"):
        solved[loss] = schur_ba_solve(tp, to, SchurConfig(iterations=15, loss=loss))
        expected = j_schur_ba_solve(jp, jo, JConfig(iterations=15, loss=loss))
        for got, exp in zip(solved[loss], expected):
            _close(got, exp, 1e-9)
    assert _cost(solved["l1"], clean) < _cost(solved["l2"], clean)


def test_singular_point_block_gives_what_lapack_gives():
    """A point no view sees has a zero block (pinned by the damping only):
    the step stays finite, as in the JAX package; nothing raises."""
    rng = np.random.default_rng(3)
    _, start, (pixels, vis) = _make_problem(rng, noise=0.02)
    vis = vis.copy()
    vis[:, 3] = False
    (jp, jo), (tp, to) = _pair(start, (pixels, vis))
    solved = schur_ba_solve(tp, to, SchurConfig(iterations=3))
    expected = j_schur_ba_solve(jp, jo, JConfig(iterations=3))
    for got, exp in zip(solved, expected):
        _close(got, exp, 1e-9)
    assert np.all(np.isfinite(to_numpy(solved.points)))
