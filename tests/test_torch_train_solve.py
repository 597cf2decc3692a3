"""The training solve: the port's differentiable ``bfgs_solve`` against the
JAX package's ``lax.scan`` unroll, values and ``jax.grad`` gradients.

Float64 throughout.  The loss is ``sum(w * solve(x0))`` for fixed weights
``w``; its gradient with respect to the starts ``x0`` runs back through
every unrolled step (the Hessian updates, the objective's own gradient),
the line search being zero-gradient on both sides.  Tolerances: values to
1e-9 and gradients to 1e-7, relative to their scale (rounding compounds
over the steps and through the second derivatives).

Drop-path draws differ between ``jax.random`` and torch, so the JAX
package's keep-masks (``uniform(subkey) > p`` with ``subkey, key =
split(key)`` once a step) are recomputed here and injected into the port;
the port's own draws are checked by their statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.camera import calibration_error as j_calibration_error
from davo_tpu.data import SceneConfig as JSceneConfig
from davo_tpu.data import generate_batch as j_generate_batch
from davo_tpu.solve import BFGSConfig as JBFGSConfig
from davo_tpu.solve import bfgs_solve as j_bfgs_solve
from davo_tpu_torch.camera import calibration_error
from davo_tpu_torch.solve import BFGSConfig, bfgs_solve, update_inverse_hessian
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

VALUE_TOL, GRAD_TOL = 1e-9, 1e-7
B = 6


def _quadratic(rng, p):
    """Per-element SPD quadratics ``0.5 (x - c)' A (x - c)``."""
    a = rng.normal(size=(B, p, p)) / np.sqrt(p)
    a = np.eye(p) + np.einsum("bij,bkj->bik", a, a)
    c = rng.normal(size=(B, p))
    j_fn = lambda x: 0.5 * jnp.einsum("bi,bij,bj->b", x - c, a, x - c)  # noqa: E731
    ta, tc = torch.tensor(a), torch.tensor(c)
    t_fn = lambda x: 0.5 * torch.einsum("bi,bij,bj->b", x - tc, ta, x - tc)  # noqa: E731
    return j_fn, t_fn, rng.normal(size=(B, p))


def _rosenbrock(rng, p=4):
    def j_fn(x):
        return jnp.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2, axis=-1)

    def t_fn(x):
        return torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2, dim=-1)

    return j_fn, t_fn, rng.uniform(-1.5, 1.5, size=(B, p))


def _calibration(rng):
    scenes = j_generate_batch(jax.random.key(3), B, JSceneConfig(dtype=jnp.float64))
    pts, vis = np.asarray(scenes.projected_points), np.asarray(scenes.visibility_mask).astype(np.float64)
    p = 3 + 3 * 8 + 6 * 3
    x0 = 0.1 * rng.normal(size=(B, p))
    x0[:, 0] += 1.0
    x0[:, 5 : 3 + 3 * 8 : 3] += 1.0
    j_fn = lambda x: j_calibration_error(x, jnp.asarray(pts), jnp.asarray(vis))  # noqa: E731
    tp, tv = torch.tensor(pts), torch.tensor(vis)
    t_fn = lambda x: calibration_error(x, tp, tv)  # noqa: E731
    return j_fn, t_fn, x0


PROBLEMS = {
    "quadratic": lambda rng: _quadratic(rng, 5),
    "rosenbrock": _rosenbrock,
    "calibration": _calibration,
}


def _jax_keep_masks(key, iterations, p, batch=B):
    masks = []
    for _ in range(iterations):
        subkey, key = jax.random.split(key)
        masks.append(np.asarray(jax.random.uniform(subkey, (batch,), dtype=jnp.float32) > p))
    return np.stack(masks)


def _both(problem, fields, *, training=True, key=None, keep_masks=None, direction_fns=(None, None), seed=0):
    """Value and gradient of ``sum(w * solve(x0))`` in JAX and in the port."""
    rng = np.random.default_rng(seed)
    j_fn, t_fn, x0 = PROBLEMS[problem](rng)
    w = rng.normal(size=x0.shape)
    j_config, config = JBFGSConfig(**fields), BFGSConfig(**fields)

    def j_loss(x):
        out = j_bfgs_solve(j_fn, x, j_config, training=training, key=key, direction_fn=direction_fns[0])
        return jnp.sum(w * out), out

    (_, j_out), j_grad = jax.value_and_grad(j_loss, has_aux=True)(jnp.asarray(x0))
    tx = torch.tensor(x0, requires_grad=True)
    out = bfgs_solve(
        t_fn, tx, config, training=training, differentiable=True, direction_fn=direction_fns[1],
        keep_masks=None if keep_masks is None else torch.tensor(keep_masks),
    )
    (grad,) = torch.autograd.grad(torch.sum(torch.tensor(w) * out), tx)
    return (np.asarray(j_out), np.asarray(j_grad)), (out.detach().numpy(), grad.numpy()), x0


def _close(actual, expected, tol, name):
    scale = max(1.0, float(np.max(np.abs(expected))))
    np.testing.assert_allclose(actual, expected, rtol=tol, atol=tol * scale, err_msg=name)


BASE = dict(iterations=50, training_iterations=6, line_search_iterations=30, drop_path_p=0.0, error_threshold=1e-12)


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
@pytest.mark.parametrize("line_search", ["wolfe", "backtracking"])
def test_unrolled_solve_values_and_gradients(problem, line_search):
    (j_out, j_grad), (out, grad), x0 = _both(problem, dict(BASE, line_search_method=line_search))
    _close(out, j_out, VALUE_TOL, "values")
    _close(grad, j_grad, GRAD_TOL, "gradients")
    assert not np.allclose(out, x0)  # the solve moved
    assert np.all(np.isfinite(grad))


@pytest.mark.parametrize("problem", ["rosenbrock", "calibration"])
def test_drop_path_with_injected_masks(problem):
    key = jax.random.key(7)
    fields = dict(BASE, drop_path_p=0.4)
    masks = _jax_keep_masks(key, fields["training_iterations"], 0.4)
    assert 0 < masks.mean() < 1
    (j_out, j_grad), (out, grad), _ = _both(problem, fields, key=key, keep_masks=masks)
    _close(out, j_out, VALUE_TOL, "values")
    _close(grad, j_grad, GRAD_TOL, "gradients")


@pytest.mark.parametrize(
    "fields",
    [
        dict(return_second_last=True, training_error_threshold=1e-3),
        dict(training_error_threshold=0.5, training_iterations=8),  # elements stop on the training threshold
        dict(warm_start_line_search=True),
        dict(warm_start_line_search=True, line_search_method="backtracking", warm_start_max_alpha=1.0),
        dict(max_step_distance=0.3, min_step_distance=1e-3, hessian_dtype="float32"),
    ],
    ids=["return_second_last", "training_threshold", "warm_start", "warm_start_backtracking", "clamped_direction"],
)
def test_training_options(fields):
    (j_out, j_grad), (out, grad), _ = _both("rosenbrock", dict(BASE, **fields))
    _close(out, j_out, VALUE_TOL, "values")
    _close(grad, j_grad, GRAD_TOL, "gradients")


def test_return_second_last_lags_one_step():
    """With ``return_second_last`` an element that stops moving keeps the
    iterate before its last step."""
    _, t_fn, x0 = _quadratic(np.random.default_rng(0), 5)
    fields = dict(BASE, training_iterations=40, minimum_step=1e-3)
    last, second_last = (
        bfgs_solve(t_fn, torch.tensor(x0), BFGSConfig(**fields, return_second_last=flag), training=True)
        for flag in (False, True)
    )
    assert not torch.allclose(last, second_last)


def test_direction_fn():
    def j_direction(direction, params, error, step_idx):
        return direction * (1.0 + 0.1 * jnp.tanh(params)) * 0.9**step_idx

    def t_direction(direction, params, error, step_idx):
        return direction * (1.0 + 0.1 * torch.tanh(params)) * 0.9**step_idx

    (j_out, j_grad), (out, grad), _ = _both("rosenbrock", BASE, direction_fns=(j_direction, t_direction))
    _close(out, j_out, VALUE_TOL, "values")
    _close(grad, j_grad, GRAD_TOL, "gradients")
    _, t_fn, x0 = _rosenbrock(np.random.default_rng(0))
    plain = bfgs_solve(t_fn, torch.tensor(x0), BFGSConfig(**BASE), training=True).detach().numpy()
    assert not np.allclose(out, plain)


def test_eval_warm_start_matches():
    """The warm start in the eval solve (kernel K1's plain version on the
    CPU), values against the JAX eval solve over 15 iterations (Rosenbrock
    amplifies rounding near its minimum: past about 20 iterations the two
    drift by more than the tolerance with or without the warm start)."""
    rng = np.random.default_rng(4)
    j_fn, t_fn, x0 = _rosenbrock(rng)
    for method in ("wolfe", "backtracking"):
        fields = dict(BASE, iterations=15, warm_start_line_search=True, line_search_method=method)
        j_out = j_bfgs_solve(j_fn, jnp.asarray(x0), JBFGSConfig(**fields))
        out = bfgs_solve(t_fn, torch.tensor(x0), BFGSConfig(**fields))
        _close(out.numpy(), np.asarray(j_out), VALUE_TOL, method)


def test_non_positive_curvature_skip_has_finite_gradient():
    """A concave start (``x^4/4 - x^2`` near 0) makes steps with y.s <= 0,
    which skip the update; the gradient through them is finite and equals
    JAX's."""
    rng = np.random.default_rng(5)
    x0 = rng.uniform(-0.3, 0.3, size=(B, 3))
    w = rng.normal(size=x0.shape)
    fields = dict(BASE, training_iterations=4)

    def j_loss(x):
        fn = lambda q: jnp.sum(q**4 / 4 - q**2, axis=-1)  # noqa: E731
        return jnp.sum(w * j_bfgs_solve(fn, x, JBFGSConfig(**fields), training=True))

    j_grad = np.asarray(jax.grad(j_loss)(jnp.asarray(x0)))
    tx = torch.tensor(x0, requires_grad=True)
    out = bfgs_solve(lambda q: torch.sum(q**4 / 4 - q**2, dim=-1), tx, BFGSConfig(**fields), training=True)
    (grad,) = torch.autograd.grad(torch.sum(torch.tensor(w) * out), tx)
    assert np.all(np.isfinite(grad.numpy()))
    _close(grad.numpy(), j_grad, GRAD_TOL, "gradients")

    # the guard itself: y.s <= 0 leaves H unchanged, with zero (not NaN) gradients
    h = torch.eye(3, dtype=torch.float64).repeat(2, 1, 1).requires_grad_(True)
    s = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype=torch.float64, requires_grad=True)
    y = (-s).detach().requires_grad_(True)
    out = update_inverse_hessian(h, s, y)
    assert torch.equal(out.detach(), h.detach())
    grads = torch.autograd.grad(out.sum(), (h, s, y))
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[1].abs().max()) == 0.0 and float(grads[2].abs().max()) == 0.0


def test_zero_training_iterations_returns_the_guess_with_its_graph():
    x0 = torch.randn(B, 4, dtype=torch.float64, requires_grad=True)
    guess = 2.0 * x0
    out = bfgs_solve(lambda x: torch.sum(x**2, dim=-1), guess, BFGSConfig(training_iterations=0), training=True,
                     generator=torch.Generator().manual_seed(0))
    assert out is guess
    (grad,) = torch.autograd.grad(out.sum(), x0)
    assert torch.equal(grad, torch.full_like(x0, 2.0))


def test_drop_path_freeze_statistics():
    """The port's own keep-masks: an element still updates at step t with
    probability (1 - p)^(t + 1).  Solves of 1, 2 and 3 steps from one seed
    share their masks' prefix, so the elements whose result changes
    between t and t + 1 steps are those kept through step t."""
    p, batch = 0.3, 4000
    rng = np.random.default_rng(6)
    x0 = torch.tensor(rng.uniform(-1.5, 1.5, size=(batch, 2)))

    def fn(x):
        return torch.sum(100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2, dim=-1)

    results = []
    for steps in (1, 2, 3):
        config = BFGSConfig(training_iterations=steps, drop_path_p=p, error_threshold=-1.0, minimum_step=0.0,
                            line_search_iterations=30)
        results.append(bfgs_solve(fn, x0, config, training=True, generator=torch.Generator().manual_seed(11)).detach())
    kept_first = (results[0] != x0).any(dim=1).double().mean().item()
    for t in (1, 2):
        moved = (results[t] != results[t - 1]).any(dim=1).double().mean().item()
        expected = (1 - p) ** (t + 1)
        sigma = (expected * (1 - expected) / batch) ** 0.5
        assert abs(moved - expected) < 4 * sigma, (t, moved, expected)
    expected = 1 - p
    assert abs(kept_first - expected) < 4 * (expected * p / batch) ** 0.5


def test_drop_path_needs_a_generator_and_fused_kernel_is_eval_only():
    fn = lambda x: torch.sum(x**2, dim=-1)  # noqa: E731
    with pytest.raises(ValueError, match="generator or keep_masks"):
        bfgs_solve(fn, torch.zeros(2, 3), BFGSConfig(drop_path_p=0.1, training_iterations=2), training=True)
    with pytest.raises(ValueError, match="non-differentiable"):
        bfgs_solve(fn, torch.zeros(2, 3), BFGSConfig(fused_hessian_kernel=True), differentiable=True)
    with pytest.raises(ValueError, match="no eval route"):
        bfgs_solve(fn, torch.zeros(2, 3), BFGSConfig(fused_hessian_kernel=False))
