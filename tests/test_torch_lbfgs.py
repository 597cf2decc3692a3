"""The port's L-BFGS and SGD solvers against the JAX package's, float64 on
the CPU.

* ``_two_loop_direction`` on an empty history (every ``rho = 0``), a
  history with skipped slots and a full one: 1e-12 relative.
* The eval ``lbfgs_solve`` on the calibration objective (three
  configurations: the history shorter than the solve, the interpolating
  zoom with a step cap, a clamped direction), and through the fused
  objective's ``value_and_grad_fn`` hook (kernel K2's plain version on
  the CPU): solved parameters to 1e-7 relative to their scale, as the
  BFGS eval solve is held (rounding compounds over the iterations).
* Elements frozen from the first step and pairs with ``s.y <= 0`` (a
  line search cut to 2 probes): the frozen elements keep their starts
  exactly, and the solve still matches JAX's to 1e-7.
* The differentiable unroll: values to 1e-9 and ``jax.grad`` gradients of
  ``sum(w * solve(x0))`` to 1e-7 relative, with the JAX package's
  drop-path keep-masks recomputed from its key and injected.
* The calibration network with an ``LBFGSConfig`` (2 restarts) against
  the JAX network, as the BFGS network is held (1e-6 relative).
* ``sgd_solve``, both modes: values to 1e-12, the differentiable mode's
  gradient to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import davo_tpu.models.calibration_network as j_network_module
from davo_tpu.camera import calibration_error_fast as j_fast
from davo_tpu.models import CalibrationNetwork as JNetwork
from davo_tpu.solve import LBFGSConfig as JLBFGSConfig
from davo_tpu.solve import SGDConfig as JSGDConfig
from davo_tpu.solve import lbfgs_solve as j_lbfgs_solve
from davo_tpu.solve import sgd_solve as j_sgd_solve
from davo_tpu.solve.lbfgs import _two_loop_direction as j_two_loop
from davo_tpu_torch.camera import calibration_error_fast as t_fast
from davo_tpu_torch.models import CalibrationNetwork, flax_to_state_dict
from davo_tpu_torch.ops import make_fused_calibration_objective
from davo_tpu_torch.solve import LBFGSConfig, SGDConfig, lbfgs_solve, sgd_solve
from davo_tpu_torch.solve.lbfgs import _two_loop_direction
from tests.test_torch_calibration_network import M, N, P, _kernel_function_objective, _scenes
from tests.test_torch_solve import _calibration_problem, j_rosenbrock, t_rosenbrock
from tests.test_torch_train_solve import PROBLEMS, _jax_keep_masks
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

SOLVE_TOL, VALUE_TOL, GRAD_TOL = 1e-7, 1e-9, 1e-7


def _close(actual, expected, tol, name=""):
    """Within ``tol`` relative to the scale of ``expected``."""
    expected = np.asarray(expected)
    scale = max(float(np.max(np.abs(expected))), 1e-300)
    np.testing.assert_allclose(np.asarray(actual), expected, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("history", ["empty", "skipped", "full"])
def test_two_loop_direction_matches_jax(history, rng):
    m, b, p = 5, 7, 6
    s = rng.normal(size=(m, b, p))
    y = s + 0.3 * rng.normal(size=(m, b, p))  # y.s > 0 mostly
    rho = 1.0 / np.abs(np.sum(s * y, axis=-1))
    if history == "empty":
        rho[:] = 0.0
        s[:] = 0.0
        y[:] = 0.0
    elif history == "skipped":
        skipped = rng.random((m, b)) < 0.4
        rho[skipped] = 0.0
        s[skipped] = 0.0
        y[skipped] = 0.0
    gamma = rng.uniform(0.1, 2.0, size=(b, 1))
    g = rng.normal(size=(b, p))
    want = np.asarray(j_two_loop(*(jnp.asarray(a) for a in (g, s, y, rho, gamma)), m))
    got = _two_loop_direction(*(torch.tensor(a) for a in (g, s, y, rho, gamma)), m)
    _close(got.numpy(), want, 1e-12)
    if history == "empty":
        _close(got.numpy(), -gamma * g, 1e-15)
    # the stacked history and a list of its slots give the same direction
    as_lists = _two_loop_direction(torch.tensor(g), list(torch.tensor(s)), list(torch.tensor(y)),
                                   list(torch.tensor(rho)), torch.tensor(gamma), m)
    np.testing.assert_array_equal(as_lists.numpy(), got.numpy())


EVAL_CONFIGS = {
    "history_3_of_12": dict(history=3, iterations=12, line_search_iterations=50),
    "interpolate_capped": dict(history=5, iterations=10, line_search_iterations=20, zoom_method="interpolate",
                               max_step_size=4.0),
    "clamped_direction": dict(history=4, iterations=10, line_search_iterations=50, max_step_distance=0.3,
                              min_step_distance=1e-3),
}


@pytest.mark.parametrize("name", sorted(EVAL_CONFIGS))
def test_lbfgs_eval_matches_jax(name):
    guess, pixels, vis = _calibration_problem(3)
    fields = dict(error_threshold=1e-7, **EVAL_CONFIGS[name])
    vis_f = vis.astype(np.float64)
    j_out = j_lbfgs_solve(lambda q: j_fast(q, jnp.asarray(pixels), jnp.asarray(vis_f)), jnp.asarray(guess),
                          JLBFGSConfig(**fields))
    x0 = torch.tensor(guess, requires_grad=True)
    out = lbfgs_solve(lambda q: t_fast(q, torch.tensor(pixels), torch.tensor(vis_f)), x0, LBFGSConfig(**fields))
    assert not out.requires_grad  # the eval result carries no gradient
    _close(out.numpy(), j_out, SOLVE_TOL)
    start = t_fast(torch.tensor(guess), torch.tensor(pixels), torch.tensor(vis_f))
    assert torch.all(t_fast(out, torch.tensor(pixels), torch.tensor(vis_f)) <= start)


def test_lbfgs_eval_through_the_value_and_grad_hook():
    """The eval solve with the fused objective's closures (K2's plain
    version on the CPU) against JAX's solve of the plain objective."""
    guess, pixels, vis = _calibration_problem(4)
    vis_f = vis.astype(np.float64)
    fields = dict(error_threshold=1e-7, iterations=10, line_search_iterations=50, history=5)
    j_out = j_lbfgs_solve(lambda q: j_fast(q, jnp.asarray(pixels), jnp.asarray(vis_f)), jnp.asarray(guess),
                          JLBFGSConfig(**fields))
    calls = []
    error_fn, value_and_grad = make_fused_calibration_objective(torch.tensor(pixels), torch.tensor(vis_f))

    def counted(params):
        calls.append(1)
        return value_and_grad(params)

    out = lbfgs_solve(error_fn, torch.tensor(guess), LBFGSConfig(**fields), value_and_grad_fn=counted)
    assert len(calls) == 10
    _close(out.numpy(), j_out, SOLVE_TOL)


def test_frozen_elements_and_nonpositive_curvature():
    """Two elements start at the minimum (frozen by the threshold at step
    0); a line search cut to 2 probes accepts steps where ``s.y <= 0``,
    whose pairs are skipped (``rho = 0``)."""
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-1.5, 1.5, size=(16, 2))
    x0[:2] = 1.0  # the minimum: error 0
    fields = dict(error_threshold=1e-10, iterations=15, line_search_iterations=2, history=4)
    j_out = np.asarray(j_lbfgs_solve(j_rosenbrock, jnp.asarray(x0), JLBFGSConfig(**fields)))
    iterates = []

    def record(direction, params, error, step_idx):
        iterates.append(params.clone())
        return direction

    out = lbfgs_solve(t_rosenbrock, torch.tensor(x0), LBFGSConfig(**fields), direction_fn=record)
    _close(out.numpy(), j_out, SOLVE_TOL)
    np.testing.assert_array_equal(out.numpy()[:2], x0[:2])
    # some pair of consecutive iterates that moved has s.y <= 0
    xs = torch.stack(iterates)
    with torch.enable_grad():
        x = xs.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(t_rosenbrock(x).sum(), x)
    s, y = xs[1:] - xs[:-1], g[1:] - g[:-1]
    moved = torch.linalg.vector_norm(s, dim=-1) > 0
    assert bool(torch.any(moved & (torch.sum(s * y, dim=-1) <= 0)))


@pytest.mark.parametrize(
    "problem,fields",
    [
        ("quadratic", dict(history=3)),
        ("rosenbrock", dict(history=5)),
        ("calibration", dict(history=4)),
        ("rosenbrock", dict(history=2, return_second_last=True, training_error_threshold=1e-3)),
    ],
    ids=["quadratic", "rosenbrock", "calibration", "rosenbrock_second_last"],
)
def test_differentiable_unroll_matches_jax_grad(problem, fields):
    rng = np.random.default_rng(7)
    j_fn, t_fn, x0 = PROBLEMS[problem](rng)
    w = rng.normal(size=x0.shape)
    iterations = 6
    fields = dict(error_threshold=1e-12, iterations=50, training_iterations=iterations, line_search_iterations=30,
                  drop_path_p=0.3, **fields)
    key = jax.random.key(11)
    masks = _jax_keep_masks(key, iterations, 0.3, batch=x0.shape[0])
    assert 0 < masks.mean() < 1

    def j_loss(x):
        out = j_lbfgs_solve(j_fn, x, JLBFGSConfig(**fields), training=True, key=key)
        return jnp.sum(w * out), out

    (_, j_out), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(x0))
    tx = torch.tensor(x0, requires_grad=True)
    out = lbfgs_solve(t_fn, tx, LBFGSConfig(**fields), training=True, keep_masks=torch.tensor(masks))
    (grad,) = torch.autograd.grad(torch.sum(torch.tensor(w) * out), tx)
    _close(out.detach().numpy(), j_out, VALUE_TOL, "values")
    _close(grad.numpy(), j_grad, GRAD_TOL, "gradients")
    assert float(np.max(np.abs(np.asarray(j_grad)))) > 0.0


def test_drop_path_needs_a_generator_or_masks():
    with pytest.raises(ValueError, match="generator or keep_masks"):
        lbfgs_solve(t_rosenbrock, torch.zeros(2, 2), LBFGSConfig(drop_path_p=0.1), training=True)
    out = lbfgs_solve(t_rosenbrock, torch.zeros(64, 2), LBFGSConfig(drop_path_p=0.5, training_iterations=3),
                      training=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()


def test_network_with_lbfgs_matches_jax(monkeypatch):
    """The network's eval restarts through L-BFGS: the JAX side's fused
    objective is its kernel's function, as in the BFGS network test."""
    monkeypatch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
    pts, vis, _ = _scenes(8)
    solver = dict(error_threshold=1e-7, iterations=10, line_search_iterations=50, history=5)
    kwargs = dict(num_views=M, num_points=N, hidden_size=32, head="transformer", transformer_layers=2,
                  transformer_heads=4, num_restarts=2)
    j_net = JNetwork(solver=JLBFGSConfig(**solver), fused_objective=True, **kwargs)
    variables = j_net.init(jax.random.key(1), jnp.asarray(pts), jnp.asarray(vis))
    variables = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), variables)
    j_out = j_net.apply(variables, jnp.asarray(pts), jnp.asarray(vis))
    draws = np.asarray(jax.random.normal(jax.random.key(0), (8, 1, P), jnp.float64))
    net = CalibrationNetwork(solver=LBFGSConfig(**solver), device="cpu", dtype=torch.float64, **kwargs)
    net.load_state_dict(flax_to_state_dict(variables["params"]))
    out = net(torch.tensor(pts), torch.tensor(vis), restart_draws=torch.tensor(draws))
    _close(out.numpy(), j_out, 1e-6)


@pytest.mark.parametrize("differentiable", [False, True], ids=["eval", "differentiable"])
def test_sgd_matches_jax(differentiable):
    rng = np.random.default_rng(2)
    j_fn, t_fn, x0 = PROBLEMS["quadratic"](rng)
    w = rng.normal(size=x0.shape)
    config = dict(learning_rate=0.05, iterations=12)

    def j_loss(x):
        out = j_sgd_solve(j_fn, x, JSGDConfig(**config), differentiable=differentiable)
        return jnp.sum(w * out), out

    (_, j_out), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(x0))
    tx = torch.tensor(x0, requires_grad=True)
    out = sgd_solve(t_fn, tx, SGDConfig(**config), differentiable=differentiable)
    _close(out.detach().numpy(), j_out, 1e-12, "values")
    if differentiable:
        (grad,) = torch.autograd.grad(torch.sum(torch.tensor(w) * out), tx)
        _close(grad.numpy(), j_grad, 1e-10, "gradients")
    else:
        assert not out.requires_grad
        assert float(np.max(np.abs(np.asarray(j_grad)))) == 0.0  # JAX's zero tangent
