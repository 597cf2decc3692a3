"""Parity of the port's geometry and calibration objective with the JAX
package (float64 on the CPU).

Tolerances: values 1e-12 relative; gradients 1e-10 relative with an
absolute floor of 1e-10 times the largest component (sums over views
and points round in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu import camera as jcam
from davo_tpu import geometry as jgeo
from davo_tpu.camera import calibration_fast as jfast
from davo_tpu_torch import camera as tcam
from davo_tpu_torch import geometry as tgeo
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def _close(actual, expected, rtol=1e-10):
    expected = np.asarray(expected)
    np.testing.assert_allclose(
        actual, expected, rtol=rtol, atol=rtol * max(1.0, float(np.max(np.abs(expected))))
    )


def _grad_t(fn, *arrays):
    tensors = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*tensors)
    grads = torch.autograd.grad(out.sum(), tensors)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _grad_j(fn, *arrays):
    args = [jnp.asarray(a) for a in arrays]
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(lambda *a: fn(*a).sum(), argnums=tuple(range(len(args)))))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def test_rotate_vector_axis_angle_values_and_grads(rng):
    vec = rng.normal(size=(7, 3))
    aa = rng.normal(size=(7, 3))
    aa[0] = 0.0  # identity
    aa[1] *= 1e-5  # deep Taylor branch
    aa[2] = [np.pi, 0.0, 0.0]
    t_out, t_g = _grad_t(tgeo.rotate_vector_axis_angle, vec, aa)
    j_out, j_g = _grad_j(jgeo.rotate_vector_axis_angle, vec, aa)
    _close(t_out, j_out, 1e-12)
    for a, b in zip(t_g, j_g):
        _close(a, b)
    assert np.all(np.isfinite(t_g[1]))


def test_axis_angle_from_matrix_round_trip(rng):
    aa = rng.normal(size=(16, 3))
    aa[0] = 0.0
    aa[1] = [0.0, 3.0, 0.0]  # near pi: a non-w pivot
    mats = np.asarray(jgeo.so3_rotation_matrix(jnp.asarray(aa)))
    t_q = tgeo.quaternion_from_matrix(torch.tensor(mats)).numpy()
    _close(t_q, jgeo.quaternion_from_matrix(jnp.asarray(mats)), 1e-12)
    t_aa = tgeo.axis_angle_from_matrix(torch.tensor(mats)).numpy()
    _close(t_aa, jgeo.axis_angle_from_matrix(jnp.asarray(mats)), 1e-12)
    _close(t_aa, aa, 1e-9)


def test_homogeneous_rays_and_angle_distance(rng):
    pts = rng.normal(size=(5, 4, 2))
    intr = rng.normal(size=(5, 1, 3))
    intr[0, 0, 0] = 0.0  # the elu kink
    t_out, t_g = _grad_t(tgeo.pixel_coordinates_to_homogeneous, pts, intr)
    j_out, j_g = _grad_j(jgeo.pixel_coordinates_to_homogeneous, pts, intr)
    _close(t_out, j_out, 1e-14)
    for a, b in zip(t_g, j_g):
        _close(a, b, 1e-14)

    a = rng.normal(size=(9, 3))
    b = rng.normal(size=(9, 3))
    b[0] = 2.5 * a[0]  # exact zero distance
    b[1] = -a[1]  # opposite: distance pi
    t_out, t_g = _grad_t(tgeo.projective_plane_angle_distance, a, b)
    j_out, j_g = _grad_j(jgeo.projective_plane_angle_distance, a, b)
    _close(t_out, j_out, 1e-12)
    for x, y in zip(t_g, j_g):
        _close(x, y)
        assert np.all(np.isfinite(x))


def test_pack_unpack_round_trip(rng):
    m, n = 4, 8
    p = tcam.num_calibration_parameters(m, n)
    assert p == jcam.num_calibration_parameters(m, n) == 45
    params = rng.normal(size=(3, 2, p))
    t_parts = tcam.unpack_calibration_parameters(torch.tensor(params), m, n)
    j_parts = jcam.unpack_calibration_parameters(jnp.asarray(params), m, n)
    for a, b in zip(t_parts, j_parts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tcam.pack_calibration_parameters(t_parts).numpy(), params)
    with pytest.raises(ValueError):
        tcam.unpack_calibration_parameters(torch.tensor(params[..., :-1]), m, n)


def _problem(seed, batch, m=4, n=8):
    rng = np.random.default_rng(seed)
    pixels = rng.uniform(-1.0, 1.0, size=(batch, m, n, 2))
    vis = (rng.random((batch, m, n)) > 0.15).astype(np.float64)
    p = 3 + 3 * n + 6 * (m - 1)
    params = 0.3 * rng.normal(size=(batch, p))
    params[:, 0] += rng.normal(size=batch)
    params[:, 5 : 3 + 3 * n : 3] += 1.0
    params[0, 3 + 3 * n + 3 * (m - 1) :] = 0.0  # identity rotations
    params[1, 3 + 3 * n + 3 * (m - 1) :] *= 1e-4  # small angles
    vis[2, 1, :3] = 0.0  # masked observations
    return params, pixels, vis


def test_camera_relative_points(rng):
    params, _, _ = _problem(1, 6)
    t_parts = tcam.unpack_calibration_parameters(torch.tensor(params), 4, 8)
    j_parts = jcam.unpack_calibration_parameters(jnp.asarray(params), 4, 8)
    t_rel = tcam.get_camera_relative_points(*[torch.tensor(np.asarray(x)) for x in j_parts[1:]])
    _close(t_rel.numpy(), jcam.get_camera_relative_points(*j_parts[1:]), 1e-12)
    # the gauge floor: an all-zero scene stays finite
    zero = torch.zeros_like(t_parts.world_points)
    out = tcam.get_camera_relative_points(zero, torch.zeros_like(t_parts.camera_translations), t_parts.camera_rotations)
    assert torch.all(torch.isfinite(out))


def test_calibration_error_values_and_grads():
    params, pts, vis = _problem(2, 8)
    t_out, t_g = _grad_t(lambda p: tcam.calibration_error(p, torch.tensor(pts), torch.tensor(vis)), params)
    j_out, j_g = _grad_j(lambda p: jcam.calibration_error(p, jnp.asarray(pts), jnp.asarray(vis)), params)
    _close(t_out, j_out, 1e-12)
    _close(t_g[0], j_g[0])
    # broadcasting over restarts: (B, E, P) against (B, 1, M, N, 2)
    stacked = np.stack([params, params[::-1]], axis=1)
    t_multi = tcam.calibration_error(torch.tensor(stacked), torch.tensor(pts)[:, None], torch.tensor(vis)[:, None])
    j_multi = jcam.calibration_error(jnp.asarray(stacked), jnp.asarray(pts)[:, None], jnp.asarray(vis)[:, None])
    _close(t_multi.numpy(), j_multi, 1e-12)


@pytest.mark.parametrize("approx_atan2", [False, True])
def test_channel_major_objective_values_and_grads(approx_atan2):
    params, pts, vis = _problem(3, 8)
    u = np.transpose(pts[..., 0], (1, 2, 0))
    v = np.transpose(pts[..., 1], (1, 2, 0))
    vt = np.transpose(vis, (1, 2, 0))

    def t_fn(p):
        return tcam.calibration_error_channel_major(
            p, torch.tensor(u), torch.tensor(v), torch.tensor(vt), approx_atan2=approx_atan2
        )

    def j_fn(p):
        return jfast.calibration_error_channel_major(p, u, v, vt, approx_atan2=approx_atan2)

    t_out, t_g = _grad_t(t_fn, params.T.copy())
    j_out, j_g = _grad_j(j_fn, params.T.copy())
    _close(t_out, j_out, 1e-12)
    _close(t_g[0], j_g[0])
    # the batch-major and channel-major objectives agree
    fast = tcam.calibration_error_fast(torch.tensor(params), torch.tensor(pts), torch.tensor(vis))
    if not approx_atan2:
        _close(fast.numpy(), t_out, 1e-12)


def test_first_quadrant_atan2_poly(rng):
    y = np.abs(rng.normal(size=64))
    x = np.abs(rng.normal(size=64))
    y[:4] = x[:4]  # the diagonal
    y[4], x[4] = 0.0, 0.0
    y[5] = 0.0
    t_out, t_g = _grad_t(tcam.first_quadrant_atan2_poly, y, x)
    j_out, j_g = _grad_j(jfast.first_quadrant_atan2_poly, y, x)
    _close(t_out, j_out, 1e-14)
    for a, b in zip(t_g, j_g):
        _close(a, b, 1e-12)
    np.testing.assert_allclose(t_out[5:], np.arctan2(y[5:], x[5:]), atol=2e-7)
