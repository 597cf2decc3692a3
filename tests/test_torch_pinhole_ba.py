"""The gen-1 bundle-adjustment objective and its utilities against the JAX
package's, float64, on inputs drawn with numpy from a seed.

* ``ba_error`` and ``ba_error_and_gradient`` for the l1, l2 and mixed
  norms, with ``max_gradient`` on and off, on a batch ``(B, E)`` that holds
  a clamped depth (a point behind its camera) and an angle past pi, with
  fractional visibility weights: 1e-12 relative to the largest entry.  The
  analytic gradient against torch autograd of the port's ``ba_error``
  (``max_gradient`` off, where it is the error's gradient): 1e-12.
* The parameter codec: ``ba_params_to_vector``/``from_vector`` round trip
  exactly, ``ba_add_vector`` with and without ``constrain`` and
  ``augmented_world_points`` against JAX's.
* ``wrap_axis_angle`` (angles past pi, negative components),
  ``straight_through_max`` (value; gradient 1 in x, 0 in the floor, in
  reverse and forward mode), ``project_vector_onto_axis``, and the four
  x-form ratios at 0, small values, the Taylor/exact switch and pi
  (values and first derivatives): 1e-12 (JAX's ``jax.grad`` for the
  derivatives).
* ``PinholeCameraModelL1``'s ``add``, ``masked_update`` and error against
  JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from davo_tpu import camera as jcam
from davo_tpu.geometry import wrap_axis_angle as j_wrap
from davo_tpu.utils import guards as jguards
from davo_tpu.utils import stable_trig as jtrig
from davo_tpu_torch import camera as tcam
from davo_tpu_torch.geometry import rotate_vector_axis_angle
from davo_tpu_torch.geometry import wrap_axis_angle as t_wrap
from davo_tpu_torch.utils import guards as tguards
from davo_tpu_torch.utils import stable_trig as ttrig
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

M, N, B, E = 3, 6, 3, 2
TOL = 1e-12


def _draw(seed):
    """Parameters ``(B, E, ...)`` and observations ``(B, 1, ...)``: view 0
    of estimate (0, 0) has an angle past pi, view 1 of estimate (1, 1) a
    translation that puts points behind it (the depth clamp)."""
    rng = np.random.default_rng(seed)
    batch = (B, E)
    focal = 1.0 + 0.2 * rng.normal(size=batch)
    translation = 0.5 * rng.normal(size=batch + (M, 3))
    translation[..., 2] += 4.0
    translation[1, 1, 1, 2] = -6.0
    orientation = 0.3 * rng.normal(size=batch + (M, 3))
    orientation[0, 0, 0] = [3.5, -0.4, 0.2]
    points = np.concatenate([0.5 * rng.normal(size=batch + (N - 2, 2)),
                             2.0 + 0.3 * np.abs(rng.normal(size=batch + (N - 2, 1)))], axis=-1)
    arrays = dict(focal_length=focal, cx=0.1 * rng.normal(size=batch), cy=0.1 * rng.normal(size=batch),
                  translation=translation, orientation=orientation, world_points=points)
    observed = rng.uniform(-1, 1, size=(B, 1, M, N, 2))
    visibility = rng.uniform(size=(B, 1, M, N)) * (rng.uniform(size=(B, 1, M, N)) > 0.2)
    return arrays, observed, visibility


def _pair(seed):
    arrays, observed, visibility = _draw(seed)
    j = (jcam.PinholeBAParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
         jcam.PinholeBAData(jnp.asarray(observed), jnp.asarray(visibility)))
    t = (tcam.PinholeBAParams(**{k: torch.tensor(v) for k, v in arrays.items()}),
         tcam.PinholeBAData(torch.tensor(observed), torch.tensor(visibility)))
    return j, t


def _close(actual, expected, tol=TOL, name=""):
    actual, expected = to_numpy(actual), np.asarray(expected)
    scale = max(float(np.max(np.abs(expected))), 1e-300)
    np.testing.assert_allclose(actual, expected, rtol=tol, atol=tol * scale, err_msg=name)


def test_draw_holds_a_clamped_depth_and_a_wrapped_angle():
    (_, _), (params, _) = _pair(0)
    world = tcam.augmented_world_points(params)
    raw = rotate_vector_axis_angle(world[..., None, :, :], params.orientation[..., :, None, :])
    raw = raw + params.translation[..., :, None, :]
    clamped = tcam.ba_camera_relative_points(params)
    assert bool(torch.any(raw[..., 2] < 0.0)) and bool(torch.all(clamped[..., 2] > 0.0))
    assert float(torch.linalg.vector_norm(params.orientation, dim=-1).max()) > np.pi


@pytest.mark.parametrize("max_gradient", [-1.0, 0.5], ids=["unclipped", "clipped"])
@pytest.mark.parametrize("norm", ["l1", "l2", "mixed"])
def test_error_and_analytic_gradient_match_jax(norm, max_gradient):
    (jp, jd), (tp, td) = _pair(1)
    j_cfg = jcam.PinholeBAConfig(error_norm=norm, max_gradient=max_gradient)
    t_cfg = tcam.PinholeBAConfig(error_norm=norm, max_gradient=max_gradient)
    (j_err, j_grad), j_err_only, j_uv = jax.jit(
        lambda p, d: (jcam.ba_error_and_gradient(p, d, j_cfg), jcam.ba_error(p, d, j_cfg), jcam.ba_project(p, j_cfg))
    )(jp, jd)
    t_err, t_grad = tcam.ba_error_and_gradient(tp, td, t_cfg)
    _close(t_err, j_err, name="error")
    _close(t_grad, j_grad, name="gradient")
    _close(tcam.ba_error(tp, td, t_cfg), j_err_only, name="ba_error")
    _close(tcam.ba_project(tp, t_cfg), j_uv, name="projection")


@pytest.mark.parametrize("norm", ["l1", "l2", "mixed"])
def test_analytic_gradient_is_autograd_of_the_error(norm):
    _, (tp, td) = _pair(2)
    cfg = tcam.PinholeBAConfig(error_norm=norm)
    vec = tcam.ba_params_to_vector(tp).requires_grad_(True)
    (autograd,) = torch.autograd.grad(tcam.ba_error(tcam.ba_params_from_vector(vec, M, N), td, cfg).sum(), vec)
    _, analytic = tcam.ba_error_and_gradient(tcam.ba_params_from_vector(vec.detach(), M, N), td, cfg)
    _close(analytic, autograd)


@pytest.mark.parametrize("constrain", [False, True])
def test_codec_round_trip_and_add_match_jax(constrain):
    (jp, _), (tp, _) = _pair(3)
    assert tcam.num_ba_parameters(M, N) == jcam.num_ba_parameters(M, N) == 3 + 6 * M + 3 * N - 7
    vec = tcam.ba_params_to_vector(tp)
    _close(vec, jcam.ba_params_to_vector(jp), tol=0.0)
    back = tcam.ba_params_from_vector(vec, M, N)
    assert torch.equal(tcam.ba_params_to_vector(back), vec)
    # every field comes back but the first free point's z, gauge-fixed to 0
    for name in ("focal_length", "cx", "cy", "translation", "orientation"):
        assert torch.equal(getattr(back, name), getattr(tp, name)), name
    assert torch.equal(back.world_points[..., 1:, :], tp.world_points[..., 1:, :])
    assert torch.equal(back.world_points[..., 0, :2], tp.world_points[..., 0, :2])
    assert torch.all(back.world_points[..., 0, 2] == 0.0)
    delta = np.random.default_rng(4).normal(size=tuple(vec.shape))
    delta[..., 2] -= 2.0  # drive some focal lengths below the floor
    t_new = tcam.ba_add_vector(tp, torch.tensor(delta), tcam.PinholeBAConfig(constrain=constrain))
    j_new, j_world = jax.jit(lambda p, d: (
        jcam.ba_add_vector(p, d, jcam.PinholeBAConfig(constrain=constrain)), jcam.augmented_world_points(p)
    ))(jp, jnp.asarray(delta))
    _close(tcam.augmented_world_points(tp), j_world, tol=0.0)
    for name, a, b in zip(t_new._fields, t_new, j_new):
        _close(a, b, name=name)
    with pytest.raises(ValueError, match="size"):
        tcam.ba_params_from_vector(vec[..., 1:], M, N)


def test_wrap_axis_angle_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(64, 3)) * np.array([[4.0]])
    w[:4] = [[3.5, 0.0, 0.0], [-3.5, 0.1, 0.0], [0.0, -7.0, 1.0], [1e-3, 0.0, 0.0]]
    _close(t_wrap(torch.tensor(w)), jax.jit(j_wrap)(jnp.asarray(w)))


def test_straight_through_max_value_and_derivatives():
    x = torch.tensor([-1.0, 0.5, 2.0], dtype=torch.float64, requires_grad=True)
    floor = torch.tensor([0.0, 1.0, 1.0], dtype=torch.float64, requires_grad=True)
    out = tguards.straight_through_max(x, floor)
    j_out = jguards.straight_through_max(jnp.asarray(x.detach().numpy()), jnp.asarray(floor.detach().numpy()))
    _close(out, j_out, tol=0.0)
    gx, gf = torch.autograd.grad(out.sum(), (x, floor), allow_unused=True, materialize_grads=True)
    j_gx, j_gf = jax.grad(lambda a, b: jnp.sum(jguards.straight_through_max(a, b)), argnums=(0, 1))(
        jnp.asarray(x.detach().numpy()), jnp.asarray(floor.detach().numpy()))
    _close(gx, j_gx, tol=0.0)
    _close(gf, j_gf, tol=0.0)
    assert torch.equal(gx, torch.ones(3, dtype=torch.float64)) and torch.equal(gf, torch.zeros(3, dtype=torch.float64))
    with fwAD.dual_level():
        dual = tguards.straight_through_max(fwAD.make_dual(x.detach(), torch.full_like(x, 2.0)), floor.detach())
        assert torch.equal(fwAD.unpack_dual(dual).tangent, torch.full_like(x, 2.0))


def test_project_vector_onto_axis_matches_jax():
    rng = np.random.default_rng(6)
    v, a = rng.normal(size=(8, 3)), rng.normal(size=(8, 3))
    a[0] = 0.0  # the zero axis projects to 0
    out = tguards.project_vector_onto_axis(torch.tensor(v), torch.tensor(a))
    _close(out, jguards.project_vector_onto_axis(jnp.asarray(v), jnp.asarray(a)))
    assert torch.all(out[0] == 0.0)
    norm = torch.sum(torch.tensor(a) ** 2, dim=-1)
    _close(tguards.project_vector_onto_axis(torch.tensor(v), torch.tensor(a), norm), out)


X_FORMS = [
    "sin_x_on_x",
    "one_minus_cos_x_on_x_squared",
    "cos_x_on_x_squared_minus_sin_x_on_x_cubed",
    "sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth",
]
X_POINTS = [0.0, 1e-6, 1e-3, -0.03, 0.049, 0.051, 0.2, -0.24, 0.26, 1.0, np.pi, -np.pi]


@pytest.mark.parametrize("name", X_FORMS)
def test_x_forms_values_and_derivatives(name):
    x = torch.tensor(X_POINTS, dtype=torch.float64, requires_grad=True)
    fn, j_fn = getattr(ttrig, name), getattr(jtrig, name)
    value = fn(x)
    j_value, j_grad = jax.jit(lambda a: (j_fn(a), jax.vmap(jax.grad(j_fn))(a)))(jnp.asarray(X_POINTS))
    _close(value, j_value)
    (grad,) = torch.autograd.grad(value.sum(), x)
    _close(grad, j_grad)
    with fwAD.dual_level():
        tangent = fwAD.unpack_dual(fn(fwAD.make_dual(x.detach(), torch.ones_like(x)))).tangent
    _close(tangent, grad)


def test_camera_model_add_and_masked_update_match_jax():
    (jp, jd), (tp, td) = _pair(7)
    cfg_j, cfg_t = jcam.PinholeBAConfig(constrain=True), tcam.PinholeBAConfig(constrain=True)
    j_model, t_model = jcam.PinholeCameraModelL1(jp, jd, cfg_j), tcam.PinholeCameraModelL1(tp, td, cfg_t)
    assert (t_model.batch_size, t_model.num_estimates, t_model.num_parameters) == (
        j_model.batch_size, j_model.num_estimates, j_model.num_parameters)
    delta = 0.1 * np.random.default_rng(8).normal(size=(B, E, t_model.num_parameters))
    mask = np.array([[True, False], [False, True], [True, True]])

    def jax_side(model, d, keep):
        new = model.add(d)
        merged = model.masked_update(new, keep)
        return (new.as_parameters_vector(), merged.as_parameters_vector(), merged.get_error(),
                merged.get_gradient())

    j_new, j_vec, j_err, j_grad = jax.jit(jax_side)(j_model, jnp.asarray(delta), jnp.asarray(mask))
    t_new = t_model.add(torch.tensor(delta))
    _close(t_new.as_parameters_vector(), j_new)
    t_m = t_model.masked_update(t_new, torch.tensor(mask))
    _close(t_m.as_parameters_vector(), j_vec)
    _close(t_m.get_error(), j_err)
    _close(t_m.get_gradient(), j_grad)
