"""The rest of ``geometry/`` and ``camera/simple_parameters.py``: the
port's functions against the JAX package's, float64, on numpy inputs
from fixed seeds, to 1e-12.

* ``two_vector_rotation_matrix`` and its Jacobian (``torch.func.jacfwd``
  against ``jax.jacfwd``), on random vectors with leading dimensions
  ``(2, 3)`` and at degenerate inputs (``a = 0``, ``b`` parallel to ``a``, ``b = 0``),
  where ``safe_reciprocal`` zeroes what would be inf;
* the basic, clamped and homogeneous pinhole projections, with points
  behind the camera, far behind it, at ``z = 0`` and at the origin;
* ``projective_plane_cosine_distance``, ``so3_vector_jacobian``;
* ``SimpleCameraModelParameters``: ``make``, ``as_vector``, ``stack``,
  ``rotation_matrix`` and ``project``;
* every custom autograd Function of ``utils/guards.py`` and
  ``utils/stable_trig.py`` under ``torch.func.jacfwd`` (each carries a
  vmap rule), against ``jax.jacfwd`` of the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import davo_tpu.geometry as jg
import davo_tpu_torch.geometry as tg
from davo_tpu.camera import SimpleCameraModelParameters as JSimple
from davo_tpu.utils import guards as j_guards
from davo_tpu.utils import stable_trig as j_trig
from davo_tpu_torch.camera import NUM_SIMPLE_CAMERA_PARAMS, SimpleCameraModelParameters
from davo_tpu_torch.utils import guards as t_guards
from davo_tpu_torch.utils import stable_trig as t_trig
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

TOL = 1e-12


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=tol, atol=tol)


def _vectors(seed, shape=(2, 3, 3)):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape), rng.normal(size=shape)


def _degenerate():
    a, b = _vectors(7, (4, 3))
    a[0] = 0.0  # a = 0
    a[1], b[1] = [2.0, 0.0, 0.0], [3.0, 0.0, 0.0]  # b parallel to a: b' is exactly 0
    b[2] = 0.0
    return a, b


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_two_vector_rotation_matrix_and_jacobian(case):
    a, b = _vectors(3) if case == "random" else _degenerate()
    _close(tg.two_vector_rotation_matrix(torch.tensor(a), torch.tensor(b)),
           jax.jit(jg.two_vector_rotation_matrix)(jnp.asarray(a), jnp.asarray(b)))
    d_a, d_b = tg.two_vector_rotation_jacobian(torch.tensor(a), torch.tensor(b))
    jd_a, jd_b = jax.jit(jg.two_vector_rotation_jacobian)(jnp.asarray(a), jnp.asarray(b))
    assert d_a.shape == a.shape[:-1] + (3, 3, 3)
    _close(d_a, jd_a)
    _close(d_b, jd_b)


def _camera_points():
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(3, 12, 3))
    pts[..., 2] = np.abs(pts[..., 2]) + 0.5
    pts[0, 0, 2] = -0.5  # behind the camera
    pts[0, 1, 2] = -4.0  # far behind it
    pts[0, 2, 2] = 0.0  # at z = 0
    pts[0, 3] = 0.0  # the origin
    pts[0, 4, :2] = [30.0, -40.0]  # projects far out of the image
    pts[0, 5, 0] = 0.0  # x = 0
    intrinsics = rng.normal(size=(3, 1, 3)) * 0.5
    return pts, intrinsics


@pytest.mark.parametrize(
    "name", ["project_points_clamped_pinhole", "project_points_pinhole_homogeneous", "pixel_coordinates_to_homogeneous",
             "project_points_basic_pinhole"]
)
def test_projection(name):
    pts, intrinsics = _camera_points()
    if name == "pixel_coordinates_to_homogeneous":
        pts = pts[..., :2]
    elif name == "project_points_basic_pinhole":
        pts = pts[1:]  # no z = 0
        intrinsics = intrinsics[1:]
    got = getattr(tg, name)(torch.tensor(pts), torch.tensor(intrinsics))
    want = jax.jit(getattr(jg, name))(jnp.asarray(pts), jnp.asarray(intrinsics))
    assert np.all(np.isfinite(to_numpy(got)))
    _close(got, want)


def test_clamped_projection_gradient_is_finite_and_matches():
    """The double ``where``s keep NaN out of the gradient at ``z = 0``, at
    ``x = 0`` and behind the camera."""
    pts, intrinsics = _camera_points()

    def j_loss(p, k):
        return jnp.sum(jg.project_points_clamped_pinhole(p, k) ** 2)

    jp, jk = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(pts), jnp.asarray(intrinsics))
    p, k = torch.tensor(pts, requires_grad=True), torch.tensor(intrinsics, requires_grad=True)
    torch.sum(tg.project_points_clamped_pinhole(p, k) ** 2).backward()
    assert torch.all(torch.isfinite(p.grad)) and torch.all(torch.isfinite(k.grad))
    _close(p.grad, jp, 1e-10)
    _close(k.grad, jk, 1e-10)


def test_cosine_distance_and_vector_jacobian():
    a, b = _vectors(5, (6, 3))
    a[0] = 0.0  # the invalid coordinate: normalised by the floor
    b[1] = -3.0 * a[1]  # opposite: distance 2
    got = tg.projective_plane_cosine_distance(torch.tensor(a), torch.tensor(b))
    _close(got, jax.jit(jg.projective_plane_cosine_distance)(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(got[1]) - 2.0) < 1e-12
    _close(tg.so3_vector_jacobian(torch.tensor(a)), jax.jit(jg.so3_vector_jacobian)(jnp.asarray(a)))
    assert set(tg.__all__) == set(jg.__all__)


def test_simple_camera_parameters():
    rng = np.random.default_rng(13)
    vec = rng.normal(size=(2, 3, NUM_SIMPLE_CAMERA_PARAMS))
    vec[..., 11] += 6.0  # the points lie in front of the camera
    points = rng.normal(size=(2, 3, 10, 3))
    port, ref = SimpleCameraModelParameters.make(torch.tensor(vec)), JSimple.make(jnp.asarray(vec))
    for field in SimpleCameraModelParameters._fields:
        _close(getattr(port, field), getattr(ref, field))
    _close(port.as_vector(), vec)
    _close(port.rotation_matrix(), jax.jit(JSimple.rotation_matrix)(ref))
    _close(port.project(torch.tensor(points)), jax.jit(JSimple.project)(ref, jnp.asarray(points)))
    stacked = SimpleCameraModelParameters.stack([port, port], dim=1)
    j_stacked = JSimple.stack([ref, ref], axis=1)
    _close(stacked.as_vector(), j_stacked.as_vector())
    assert stacked.as_vector().shape == (2, 2, 3, NUM_SIMPLE_CAMERA_PARAMS)
    with pytest.raises(ValueError, match="Expected 12 parameters"):
        SimpleCameraModelParameters.make(torch.zeros(11))


GUARDS = {
    "safe_reciprocal": (lambda g: g.safe_reciprocal, 1),
    "safe_norm": (lambda g: (lambda x: g.safe_norm(x, keepdim=True) if g is t_guards else g.safe_norm(x, keepdims=True)),
                  1),
    "inverse_curvature": (lambda g: g.inverse_curvature, 2),
    "interpolate_alpha": (lambda g: g.interpolate_alpha, 4),
    "straight_through_max": (lambda g: (lambda x: g.straight_through_max(x, 0.3 * x.dtype.type(1)
                                                                         if g is j_guards else 0.3)), 1),
    "sinc_sq": (lambda g: g.sinc_sq, 1),
    "sin_x_on_x": (lambda g: g.sin_x_on_x, 1),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_custom_functions_take_jacfwd(name):
    """``torch.func.jacfwd`` reaches each custom autograd Function through
    its generated vmap rule; the Jacobian equals ``jax.jacfwd``'s."""
    pick, arity = GUARDS[name]
    module_t = t_trig if name in ("sinc_sq", "sin_x_on_x") else t_guards
    module_j = j_trig if module_t is t_trig else j_guards
    rng = np.random.default_rng(17)
    args = [np.abs(rng.normal(size=(5, 3))) + 0.1 for _ in range(arity)]
    args[0][0] = 0.0  # the guarded point
    if name == "interpolate_alpha":
        args[3][1] = args[2][1]  # equal values: the bisection branch
    t_fn, j_fn = pick(module_t), pick(module_j)
    argnums = tuple(range(arity))
    got = torch.func.jacfwd(t_fn, argnums=argnums)(*(torch.tensor(x) for x in args))
    want = jax.jit(jax.jacfwd(j_fn, argnums=argnums))(*(jnp.asarray(x) for x in args))
    for g, w in zip(got, want):
        _close(g, w)
