"""The Brown-Conrady distorted camera and its calibration pipeline: the
port against the JAX package, float64 on the CPU.

* ``distorted_project`` and the closed-form
  ``distorted_project_and_jacobian`` against the JAX functions, to 1e-12,
  on parameters with leading dimensions ``(2, 3)``; the closed form also
  against the port's ``torch.func.jacfwd`` reference, to 1e-12.  One point sits at camera depth 0
  exactly, where the guard's ``zmask`` takes the depth derivative out as
  autodiff through the guard does.
* ``refine_distorted`` on scenes, starts and pixel noise drawn by JAX and
  passed across: the refined parameters to 1e-9.
* ``generate_distorted_scenes`` and ``evaluate_distorted_calibration`` on
  torch draws, held to the JAX tests' bounds
  (``tests/camera/test_distorted_calibration.py``): noiseless float64
  recovery of every parameter to 1e-4 with the residual under 1e-8,
  float32 to 5e-3, and the noise floor.
* ``python -m davo_tpu_torch.cli eval-distorted --platform cpu``: the JAX
  CLI's flags, defaults and printed keys, batch ``i`` drawn from a
  generator seeded ``--seed + i``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.camera import DistortedSceneConfig as JSceneConfig
from davo_tpu.camera import distorted_project as j_project
from davo_tpu.camera import distorted_project_and_jacobian as j_project_and_jacobian
from davo_tpu.camera import generate_distorted_scenes as j_generate
from davo_tpu.camera import refine_distorted as j_refine
from davo_tpu.solve.least_squares import LMConfig as JLMConfig
from davo_tpu_torch import cli
from davo_tpu_torch.camera import (
    DISTORTED_PARAM_NAMES,
    NUM_DISTORTED_PARAMS,
    DistortedSceneConfig,
    distorted_project,
    distorted_project_and_jacobian,
    distorted_project_and_jacobian_jacfwd,
    evaluate_distorted_calibration,
    generate_distorted_scenes,
    refine_distorted,
)
from davo_tpu_torch.camera.distortion import RX, RY, RZ, TX, TY, TZ
from davo_tpu_torch.solve.least_squares import LMConfig
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

TOL = 1e-12
REFINE_TOL = 1e-9


@pytest.fixture(scope="module")
def camera_inputs():
    """Parameters ``(2, 3, 16)`` in the scene generator's ranges, world
    points ``(2, 3, 10, 3)``; element [0, 0] has no rotation and tz = 5,
    and its point 0 lies at world z = -5: camera depth exactly 0."""
    rng = np.random.default_rng(4)
    lo = np.array([-0.2, -0.2, -0.15, -0.05, -0.01, -0.01, -0.01, 1.2, -0.02, 1.2, -0.2, -0.2, -0.2, -0.6, -0.6, 5.0])
    hi = np.array([0.2, 0.2, 0.15, 0.05, 0.01, 0.01, 0.01, 2.2, 0.02, 2.2, 0.2, 0.2, 0.2, 0.6, 0.6, 7.0])
    params = lo + (hi - lo) * rng.uniform(size=(2, 3, NUM_DISTORTED_PARAMS))
    points = rng.uniform(-1.5, 1.5, size=(2, 3, 10, 3))
    params[0, 0, [RX, RY, RZ, TX, TY]] = 0.0
    params[0, 0, TZ] = 5.0
    points[0, 0, 0] = [0.3, -0.2, -5.0]
    return points, params


def test_distorted_project_and_closed_form_jacobian(camera_inputs):
    points, params = camera_inputs
    pix, jac = distorted_project_and_jacobian(torch.tensor(points), torch.tensor(params))
    j_pix, j_jac = jax.jit(j_project_and_jacobian)(jnp.asarray(points), jnp.asarray(params))
    assert jac.shape == (2, 3, 10, 2, NUM_DISTORTED_PARAMS)
    np.testing.assert_allclose(to_numpy(pix), np.asarray(j_pix), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_numpy(jac), np.asarray(j_jac), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        to_numpy(distorted_project(torch.tensor(points), torch.tensor(params))),
        np.asarray(jax.jit(j_project)(jnp.asarray(points), jnp.asarray(params))), rtol=TOL, atol=TOL,
    )
    assert len(DISTORTED_PARAM_NAMES) == NUM_DISTORTED_PARAMS


def test_closed_form_equals_jacfwd(camera_inputs):
    """The closed form against ``torch.func.jacfwd``, the depth-0 point
    included: its depth column is the guard's."""
    points, params = camera_inputs
    _, jac = distorted_project_and_jacobian(torch.tensor(points), torch.tensor(params))
    pix_fwd, jac_fwd = distorted_project_and_jacobian_jacfwd(torch.tensor(points), torch.tensor(params))
    assert jac_fwd.shape == jac.shape
    np.testing.assert_allclose(to_numpy(jac), to_numpy(jac_fwd), rtol=TOL, atol=TOL)
    # at depth 0 the guard passes no depth derivative: tz's column is the
    # x/y part only, and finite
    assert torch.all(torch.isfinite(jac[0, 0, 0]))
    np.testing.assert_allclose(to_numpy(pix_fwd), to_numpy(distorted_project(torch.tensor(points),
                                                                             torch.tensor(params))), rtol=0, atol=0)


@pytest.fixture(scope="module")
def jax_scenes():
    """Six scenes, their starts and pixel noise of standard deviation 1
    (scaled in the test), drawn by JAX in float64."""
    k_scene, k_start, k_noise = jax.random.split(jax.random.key(9), 3)
    world, pixels, true_params = jax.jit(j_generate, static_argnums=(1, 2))(
        k_scene, 6, JSceneConfig(dtype=jnp.float64)
    )
    scale = jnp.ones((NUM_DISTORTED_PARAMS,), jnp.float64).at[13:16].set(5.0)
    start = true_params + 0.02 * scale * jax.random.normal(k_start, true_params.shape, jnp.float64)
    return world, pixels, true_params, start, jax.random.normal(k_noise, pixels.shape, jnp.float64)


@pytest.mark.parametrize("pixel_noise,iterations", [(0.0, 60), (1e-4, 5)], ids=["noiseless_60", "noise_1e-4_5"])
def test_refine_distorted_matches_jax(pixel_noise, iterations, jax_scenes):
    """Scenes, starts and pixel noise drawn by JAX and passed across; the
    refined parameters agree to 1e-9 (measured 2.5e-14 noiseless after 60
    iterations, 4.3e-14 at noise 1e-4 after 5).

    Once a noisy solve has converged (about 10 iterations), its accepted
    steps are set by rounding: each package's iterate then sits on its own
    float64 floor, and the least determined parameter (one scene's k3)
    read 1.27e-9 apart after 20-60 iterations, where the objectives agree.
    """
    world, pixels, true_params, start, noise = jax_scenes
    pixels = pixels + pixel_noise * noise
    want = jax.jit(j_refine, static_argnums=3)(world, pixels, start, JLMConfig(iterations=iterations))
    # through the batch dimensions (2, 3)
    got = refine_distorted(
        *(torch.tensor(np.asarray(x)).reshape(2, 3, *x.shape[1:]) for x in (world, pixels, start)),
        LMConfig(iterations=iterations),
    )
    np.testing.assert_allclose(to_numpy(got).reshape(6, -1), np.asarray(want), rtol=REFINE_TOL, atol=REFINE_TOL)
    error, start_error = (float(jnp.max(jnp.abs(x - true_params))) for x in (want, start))
    assert error < (1e-8 if pixel_noise == 0.0 else 0.5 * start_error)  # the solve moved towards the truth


def test_scene_generation_consistent():
    world, pixels, params = generate_distorted_scenes(
        torch.Generator().manual_seed(0), 8, DistortedSceneConfig(dtype=torch.float64), device="cpu"
    )
    assert world.shape == (8, 32, 3) and pixels.shape == (8, 32, 2) and params.shape == (8, 16)
    assert world.dtype == torch.float64
    torch.testing.assert_close(pixels, distorted_project(world, params), rtol=0, atol=0)
    assert float(torch.median(torch.abs(pixels))) < 2.0


@pytest.mark.parametrize(
    "case,kwargs",
    [
        ("noiseless_f64", dict(batch=16, perturbation=0.02, scene=DistortedSceneConfig(dtype=torch.float64))),
        ("f32", dict(batch=8, perturbation=0.01, scene=DistortedSceneConfig(dtype=torch.float32))),
        ("noise_f64", dict(batch=8, perturbation=0.02, pixel_noise=1e-3,
                           scene=DistortedSceneConfig(num_points=64, dtype=torch.float64))),
    ],
)
def test_evaluate_within_the_jax_tests_bounds(case, kwargs):
    metrics = evaluate_distorted_calibration(torch.Generator().manual_seed(3), device="cpu", **kwargs)
    assert set(metrics) == {"max_param_error", "mean_param_error", "rms_residual", "start_max_param_error"}
    if case == "noiseless_f64":
        assert metrics["start_max_param_error"] > 0.05
        assert metrics["max_param_error"] < 1e-4, metrics
        assert metrics["rms_residual"] < 1e-8, metrics
    elif case == "f32":
        assert metrics["max_param_error"] < 5e-3, metrics
    else:
        assert metrics["mean_param_error"] < 0.02, metrics
        assert metrics["max_param_error"] < 0.5, metrics
        assert 1e-4 < metrics["rms_residual"] < 5e-3, metrics


def test_cli_eval_distorted(capsys):
    """The JAX CLI's flags, defaults and printed keys
    (``davo_tpu/cli.py:411-422, 690-719``); batch ``i`` is a generator
    seeded ``seed + i``."""
    defaults = vars(cli._build_parser().parse_args(["eval-distorted"]))
    assert {k: defaults[k] for k in ("batches", "batch_size", "points", "perturbation", "pixel_noise",
                                     "lm_iterations", "seed")} == dict(
        batches=4, batch_size=16, points=32, perturbation=0.02, pixel_noise=0.0, lm_iterations=60, seed=0)
    args = ["eval-distorted", "--batches", "2", "--batch-size", "3", "--lm-iterations", "8", "--seed", "5"]
    assert cli.main(args + ["--platform", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {"max_param_error", "mean_param_error", "rms_residual", "start_max_param_error",
                            "worst_max_param_error"}
    batches = [evaluate_distorted_calibration(torch.Generator().manual_seed(5 + i), batch=3,
                                              lm=LMConfig(iterations=8), device="cpu") for i in range(2)]
    assert printed["worst_max_param_error"] == max(b["max_param_error"] for b in batches)
    assert printed["mean_param_error"] == pytest.approx(sum(b["mean_param_error"] for b in batches) / 2, rel=1e-12)
