"""Parity of the port's line searches and eval-mode BFGS solve with the
JAX package (float64 on the CPU).

Tolerances: the Hessian-update pieces 1e-12; step sizes 1e-10 (each
search makes the same accept/reject decisions, so only rounding
differs); solved parameters after 10 BFGS iterations 1e-7 relative to
their scale (rounding differences compound over the iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu import solve as jsolve
from davo_tpu.solve.line_search import line_search_backtracking as j_backtracking
from davo_tpu.camera import calibration_error_fast as j_fast
from davo_tpu_torch import solve as tsolve
from davo_tpu_torch.camera import calibration_error_fast as t_fast
from davo_tpu_torch.ops import make_fused_calibration_objective
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def j_rosenbrock(p):
    return jnp.square(1.0 - p[..., 0]) + 100.0 * jnp.square(p[..., 1] - jnp.square(p[..., 0]))


def t_rosenbrock(p):
    return torch.square(1.0 - p[..., 0]) + 100.0 * torch.square(p[..., 1] - torch.square(p[..., 0]))


def _search_inputs(seed, batch=64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(batch, 2))
    grad = np.asarray(jax.vmap(jax.grad(j_rosenbrock))(jnp.asarray(x)))
    # steepest descent scaled over several decades, and a few ascent directions
    direction = -grad * np.exp(rng.uniform(-8.0, 0.0, size=(batch, 1)))
    direction[:4] *= -1.0
    err = np.asarray(j_rosenbrock(jnp.asarray(x)))
    active = rng.random(batch) > 0.1
    return x, direction, err, grad, active


def test_hessian_update_pieces(rng):
    b, p = 16, 6
    a = rng.normal(size=(b, p, p))
    h = a @ np.swapaxes(a, 1, 2) + np.eye(p)
    s, y = rng.normal(size=(b, p)), rng.normal(size=(b, p))
    y[:3] = -s[:3]
    np.testing.assert_allclose(
        tsolve.scale_initial_inverse_hessian(torch.tensor(s), torch.tensor(y)).numpy(),
        jsolve.scale_initial_inverse_hessian(jnp.asarray(s), jnp.asarray(y)),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        tsolve.update_inverse_hessian(torch.tensor(h), torch.tensor(s), torch.tensor(y)).numpy(),
        jsolve.update_inverse_hessian(jnp.asarray(h), jnp.asarray(s), jnp.asarray(y)),
        rtol=1e-12,
        atol=1e-12,
    )
    from davo_tpu.solve.bfgs import clamp_search_direction as j_clamp

    d = rng.normal(size=(b, p)) * np.exp(rng.uniform(-6, 3, size=(b, 1)))
    for bounds in [(None, None), (0.5, None), (None, 1e-2), (0.5, 1e-2)]:
        np.testing.assert_allclose(
            tsolve.clamp_search_direction(torch.tensor(d), *bounds).numpy(),
            j_clamp(jnp.asarray(d), *bounds),
            rtol=1e-14,
        )


@pytest.mark.parametrize("init", [None, 4.0])
def test_backtracking_matches(init):
    x, d, err, grad, active = _search_inputs(0)
    init_alpha = None if init is None else np.full(len(x), init)
    j_alpha = j_backtracking(
        jnp.asarray(x), jnp.asarray(d), jnp.asarray(err), jnp.asarray(grad), j_rosenbrock,
        max_iterations=6, active=jnp.asarray(active),
        init_alpha=None if init_alpha is None else jnp.asarray(init_alpha),
    )
    t_alpha = tsolve.line_search_backtracking(
        torch.tensor(x), torch.tensor(d), torch.tensor(err), torch.tensor(grad), t_rosenbrock,
        max_iterations=6, active=torch.tensor(active),
        init_alpha=None if init_alpha is None else torch.tensor(init_alpha),
    )
    np.testing.assert_allclose(t_alpha.numpy(), np.asarray(j_alpha), rtol=1e-10, atol=1e-14)
    assert np.all(t_alpha.numpy()[~active] == 0.0)
    assert np.all(t_alpha.numpy()[:4] == 0.0)  # ascent directions never pass


@pytest.mark.parametrize(
    "strong,zoom_method,max_step",
    [(True, "bisection", None), (False, "bisection", None), (True, "interpolate", 2.0)],
)
def test_wolfe_matches(strong, zoom_method, max_step):
    x, d, err, grad, active = _search_inputs(1)
    kwargs = dict(strong=strong, zoom_method=zoom_method, max_step_size=max_step, max_iterations=50)
    j_alpha = jsolve.line_search_wolfe_conditions(
        jnp.asarray(x), jnp.asarray(d), jnp.asarray(err), jnp.asarray(grad), j_rosenbrock,
        active=jnp.asarray(active), **kwargs,
    )
    t_alpha = tsolve.line_search_wolfe_conditions(
        torch.tensor(x), torch.tensor(d), torch.tensor(err), torch.tensor(grad), t_rosenbrock,
        active=torch.tensor(active), **kwargs,
    )
    np.testing.assert_allclose(t_alpha.numpy(), np.asarray(j_alpha), rtol=1e-10, atol=1e-14)
    assert np.all(t_alpha.numpy()[~active] == 0.0)


def test_line_search_results_carry_no_gradient():
    x, d, err, grad, _ = _search_inputs(2, batch=8)
    x_t = torch.tensor(x, requires_grad=True)
    alpha = tsolve.line_search_wolfe_conditions(
        x_t, torch.tensor(d), torch.tensor(err), torch.tensor(grad), t_rosenbrock
    )
    assert not alpha.requires_grad


def _calibration_problem(seed, batch=8, m=4, n=8):
    rng = np.random.default_rng(seed)
    p = 3 + 3 * n + 6 * (m - 1)
    world = rng.normal(size=(batch, n, 3)) + np.array([0.0, 0.0, 4.0])
    pixels = world[..., None, :, :2] / world[..., None, :, 2:] + 0.05 * rng.normal(size=(batch, m, n, 2))
    vis = rng.random((batch, m, n)) > 0.1
    guess = 0.1 * rng.normal(size=(batch, p))
    guess[:, 0] += 1.0
    guess[:, 5 : 3 + 3 * n : 3] += 1.0
    return guess, pixels, vis


@pytest.mark.parametrize(
    "config",
    [
        dict(line_search_method="wolfe", line_search_iterations=50),
        dict(line_search_method="backtracking", line_search_iterations=6, minimum_step=0.0),
        dict(line_search_method="wolfe", line_search_iterations=20, zoom_method="interpolate", max_step_size=4.0),
    ],
    ids=["wolfe", "backtracking", "wolfe-interpolate"],
)
def test_bfgs_solve_matches(config):
    guess, pixels, vis = _calibration_problem(3)
    j_cfg = jsolve.BFGSConfig(error_threshold=1e-7, iterations=10, **config)
    t_cfg = tsolve.BFGSConfig(error_threshold=1e-7, iterations=10, **config)
    vis_f = vis.astype(np.float64)
    j_out = jsolve.bfgs_solve(
        lambda q: j_fast(q, jnp.asarray(pixels), jnp.asarray(vis_f)), jnp.asarray(guess), j_cfg
    )
    t_out = tsolve.bfgs_solve(
        lambda q: t_fast(q, torch.tensor(pixels), torch.tensor(vis_f)), torch.tensor(guess), t_cfg
    )
    scale = float(np.max(np.abs(np.asarray(j_out))))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-7, atol=1e-7 * scale)


def test_bfgs_value_and_grad_hook_and_bf16_carry():
    """The solve through the fused objective (the plain K2 on the CPU) and
    a bfloat16 Hessian carry lowers the error like the float32 solve."""
    guess, pixels, vis = _calibration_problem(4)
    pts = torch.tensor(pixels, dtype=torch.float32)
    error_fn, vg = make_fused_calibration_objective(pts, torch.tensor(vis))
    start = error_fn(torch.tensor(guess, dtype=torch.float32))
    results = {}
    for h_dtype in (None, "bfloat16"):
        cfg = tsolve.BFGSConfig(error_threshold=1e-7, iterations=15, line_search_iterations=20, hessian_dtype=h_dtype)
        out = tsolve.bfgs_solve(error_fn, torch.tensor(guess, dtype=torch.float32), cfg, value_and_grad_fn=vg)
        results[h_dtype] = error_fn(out)
    assert torch.all(results[None] <= start)
    assert torch.all(results["bfloat16"] <= start)
    assert float(results["bfloat16"].mean()) < 0.5 * float(start.mean())


def test_solve_rejects_unknown_search_and_non_2d_batch():
    with pytest.raises(ValueError):
        tsolve.bfgs_solve(t_rosenbrock, torch.zeros(2, 2), tsolve.BFGSConfig(line_search_method="newton"))
    with pytest.raises(ValueError):
        tsolve.bfgs_solve(t_rosenbrock, torch.zeros(2, 2, 2))
