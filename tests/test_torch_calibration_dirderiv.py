"""Kernel K4 (calibration value + directional derivative): the port's
hand-derived tangent pass against the JAX package.  The CUDA kernel itself
is held against it in ``test_torch_gpu.py`` (on the card) and
``test_torch_csrc_host.py`` (its source, compiled for the host).

Tolerances:
* float32 against the interpreted Pallas ``_dirderiv_kernel`` (whose
  tangent is ``jax.jvp``): the JAX test's own, rtol 5e-5 (atol 2e-5) on
  the error and rtol 5e-4 (atol 1e-4) on dphi
  (``tests/ops/test_calibration_obj.py``);
* float64 against ``jax.jvp`` of ``calibration_error_channel_major`` with
  the polynomial atan2 (the JAX kernel path takes float32 only): 1e-12
  relative to the largest component, on every edge case;
* float64 against ``torch.func.jvp`` of the port's own objective: 1e-12,
  away from the two conventions where torch's forward mode differs from
  JAX's (a tie of the 1e-6 clamp: torch passes the whole tangent, JAX
  half; ``|w|`` at ``w = 0``: torch passes 0, JAX ``+tangent``).

At a world point at the origin ``jax.jvp`` gives NaN (the 0 tangent of
``sqrt(0)`` times its infinite slope, through the norm's floor); the port
passes no tangent through a norm at its floor, as K2's adjoint does, and
its dphi there is held against a central difference of the JAX
objective's own values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.camera.calibration_fast import calibration_error_channel_major as j_objective
from davo_tpu.ops import calibration_obj as jk
from davo_tpu_torch.camera import calibration_error_channel_major as t_objective
from davo_tpu_torch.ops import calibration_obj as tk
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

M, N = 4, 8
P = 3 + 3 * N + 6 * (M - 1)
R0 = 3 + 3 * N + 3 * (M - 1)  # first rotation parameter
T0 = 3 + 3 * N  # first translation parameter
# the translation that puts the gauge's overall scale exactly on the 1e-6
# clamp when every point is (0, 0, 2^-22) and the other translations are 0
# (found by bisection in float64 and checked below)
TIE_TRANSLATION = 2.5569488525390624e-05
TORCH_CONVENTION_ELEMENTS = (6, 9)  # the clamp tie, a zero coordinate


def _problem(seed=0, batch=16):
    """Pixels, visibility and parameters (channel-major observations) whose
    elements take the edge cases: 0 f < 0, 1 f = 0, 2 a view with nothing
    visible, 3 identity rotations, 4 small angles, 5 the 1e-6 clamp active,
    6 the clamp at a tie, 7 d = 0, 8 points behind the cameras (the swapped
    atan2 branch), 9 a zero point coordinate."""
    rng = np.random.default_rng(seed)
    params = 0.3 * rng.normal(size=(batch, P))
    params[:, 0] += rng.normal(size=batch)
    params[:, 5 : 3 + 3 * N : 3] += 1.0
    params[0, 0] = -0.7
    params[1, 0] = 0.0
    params[3, R0:] = 0.0
    params[4, R0:] *= 1e-4
    params[5, 3:R0] *= 1e-8
    params[6, 3:R0] = 0.0
    params[6, 5 : 3 + 3 * N : 3] = 2.0**-22
    params[6, T0] = TIE_TRANSLATION
    params[8, 5 : 3 + 3 * N : 3] -= 2.5
    params[9, 4] = 0.0
    u = rng.uniform(-1.0, 1.0, size=(M, N, batch))
    v = rng.uniform(-1.0, 1.0, size=(M, N, batch))
    vis = (rng.random((M, N, batch)) > 0.2).astype(np.float64)
    vis[2, :, 2] = 0.0
    direction = rng.normal(size=(batch, P))
    direction[7] = 0.0
    return params, direction, u, v, vis


def _plain(params, direction, u, v, vis):
    err, dphi = tk.calibration_value_and_dirderiv(*(torch.tensor(x) for x in (params, direction, u, v, vis)))
    return err.numpy(), dphi.numpy()


def _jax_jvp(params, direction, u, v, vis):
    err, dphi = jax.jvp(
        lambda q: j_objective(q.T, u, v, vis, approx_atan2=True), (jnp.asarray(params),), (jnp.asarray(direction),)
    )
    return np.asarray(err), np.asarray(dphi)


def test_plain_matches_pallas_kernel_f32():
    params, direction, u, v, vis = (x.astype(np.float32) for x in _problem(1))
    j_err, j_dphi = jk.calibration_value_and_dirderiv(
        *(jnp.asarray(x) for x in (params, direction, u, v, vis)), block_b=8, interpret=True
    )
    err, dphi = _plain(params, direction, u, v, vis)
    np.testing.assert_allclose(err, np.asarray(j_err), rtol=5e-5, atol=2e-5)
    np.testing.assert_allclose(dphi, np.asarray(j_dphi), rtol=5e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 2])
def test_plain_matches_jax_jvp_f64(seed):
    problem = _problem(seed)
    err, dphi = _plain(*problem)
    j_err, j_dphi = _jax_jvp(*problem)
    np.testing.assert_allclose(err, j_err, rtol=1e-12, atol=1e-12 * np.max(np.abs(j_err)))
    np.testing.assert_allclose(dphi, j_dphi, rtol=1e-12, atol=1e-12 * np.max(np.abs(j_dphi)))
    assert dphi[7] == 0.0  # d = 0


def test_plain_matches_torch_forward_mode_f64():
    params, direction, u, v, vis = _problem(3)
    err, dphi = _plain(params, direction, u, v, vis)
    t = [torch.tensor(x) for x in (u, v, vis)]
    t_err, t_dphi = torch.func.jvp(
        lambda q: t_objective(q.T, *t, approx_atan2=True), (torch.tensor(params),), (torch.tensor(direction),)
    )
    keep = np.setdiff1d(np.arange(len(err)), TORCH_CONVENTION_ELEMENTS)
    np.testing.assert_allclose(err, t_err.numpy(), rtol=1e-12, atol=1e-12)
    scale = np.max(np.abs(dphi))
    np.testing.assert_allclose(dphi[keep], t_dphi.numpy()[keep], rtol=1e-12, atol=1e-12 * scale)


def test_edge_cases_are_exercised():
    """The problem reaches each branch: the clamp active and exactly at its
    tie, and the Kahan angle in all four regions of the polynomial atan2
    (unswapped and swapped, reduced and not)."""
    params, _, u, v, vis = _problem(0)
    w = params[:, 3:T0].reshape(-1, N, 3)
    t = params[:, T0:R0].reshape(-1, M - 1, 3)
    overall = (np.mean(np.abs(w).sum(-1), axis=1) / 3.0 * N + np.mean(np.abs(t), axis=(1, 2)) * M) / (N + M)
    assert overall[5] < 1e-6 and overall[6] == 1e-6
    # each visible term's angle (degrees) from single-term objectives
    angles = []
    pt = torch.tensor(params).T
    tu, tv = torch.tensor(u), torch.tensor(v)
    for m in range(M):
        for n in range(N):
            one = np.zeros_like(vis)
            one[m, n] = vis[m, n]
            theta = t_objective(pt, tu, tv, torch.tensor(one), approx_atan2=True).numpy()
            angles.append(np.degrees(theta[vis[m, n] > 0]))
    angles = np.concatenate(angles)
    for lo, hi in ((0, 45), (45, 90), (90, 135), (135, 180)):
        assert np.any((angles > lo) & (angles < hi)), (lo, hi)


def test_clamp_tie_takes_half_the_tangent():
    """At the tie of the 1e-6 clamp JAX's ``max`` passes half the tangent:
    the port's dphi there (element 6) is the mean of its dphi just above
    the clamp (the whole tangent) and just below it (none), each of which
    matches JAX too."""
    params, direction, u, v, vis = _problem(0)
    params, direction, u, v, vis = params[6:7], direction[6:7], u[..., 6:7], v[..., 6:7], vis[..., 6:7]
    dphis = {}
    for label, factor in (("tie", 1.0), ("above", 1.0 + 1e-9), ("below", 1.0 - 1e-9)):
        shifted = params.copy()
        shifted[0, T0] *= factor
        dphi = _plain(shifted, direction, u, v, vis)[1][0]
        np.testing.assert_allclose(dphi, _jax_jvp(shifted, direction, u, v, vis)[1][0], rtol=1e-12)
        dphis[label] = dphi
    assert dphis["above"] != dphis["below"]
    np.testing.assert_allclose(dphis["tie"], 0.5 * (dphis["above"] + dphis["below"]), rtol=1e-6)


def test_point_at_origin():
    """A world point at the origin: JAX's jvp is NaN; the port's dphi is
    finite and equals the central difference of the JAX objective."""
    rng = np.random.default_rng(4)
    params = 0.3 * rng.normal(size=(1, P))
    params[:, 0] += 1.0
    params[:, 5 : 3 + 3 * N : 3] += 1.0
    params[0, 3:6] = 0.0
    u = rng.uniform(-1.0, 1.0, size=(M, N, 1))
    v = rng.uniform(-1.0, 1.0, size=(M, N, 1))
    vis = np.ones((M, N, 1))
    direction = rng.normal(size=(1, P))
    _, j_dphi = _jax_jvp(params, direction, u, v, vis)
    assert np.isnan(j_dphi).all()
    err, dphi = _plain(params, direction, u, v, vis)
    assert np.isfinite(err).all() and np.isfinite(dphi).all()

    def objective(x):
        return np.asarray(j_objective(jnp.asarray(x).T, u, v, vis, approx_atan2=True))

    # within |q| < the norm floor the objective is smooth in the step; the
    # difference's truncation error is ~ step * 4.5e15 relative
    h = 1e-21
    central = (objective(params + h * direction) - objective(params - h * direction)) / (2 * h)
    np.testing.assert_allclose(dphi, central, rtol=1e-6)
