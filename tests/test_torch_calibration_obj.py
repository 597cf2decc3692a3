"""Kernel K2 (calibration value + gradient): the port's hand-derived
reverse pass against the JAX package.  The CUDA kernel itself is held
against it in ``test_torch_gpu.py`` (on the card) and
``test_torch_csrc_host.py`` (its source, compiled for the host).

Tolerances:
* float32 against the interpreted Pallas kernel (whose gradient is
  ``jax.vjp``): values atol 1e-4 (a sum of 32 angles of O(1) in float32),
  gradients rtol 1e-4 with atol 1e-4 (components reach ~30; both sides
  round float32 sums over views and points in different orders);
* float64 against ``jax.vjp`` of ``calibration_error_channel_major``
  (polynomial atan2) and against ``torch.autograd`` of the port's own
  objective: 1e-10 relative to the largest component (the same algebra,
  only rounding differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.camera.calibration_fast import calibration_error_channel_major as j_objective
from davo_tpu.ops import calibration_obj as jk2
from davo_tpu_torch.camera import calibration_error_channel_major as t_objective
from davo_tpu_torch.ops import calibration_obj as tk2
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def _problem(seed, batch, m, n, dtype=np.float64):
    """Pixels, visibility and parameters in channel-major layout, with
    identity and small-angle rotations, masked observations and a
    negative focal parameter (the exp branch of elu(f) + 1)."""
    rng = np.random.default_rng(seed)
    p = 3 + 3 * n + 6 * (m - 1)
    params = 0.3 * rng.normal(size=(batch, p))
    params[:, 0] += rng.normal(size=batch)
    params[0, 0] = -0.7
    params[:, 5 : 3 + 3 * n : 3] += 1.0
    r0 = 3 + 3 * n + 3 * (m - 1)
    params[1, r0:] = 0.0
    params[2, r0:] *= 1e-4
    params[3, r0:] *= 0.1  # between the two Taylor thresholds
    u = rng.uniform(-1.0, 1.0, size=(m, n, batch))
    v = rng.uniform(-1.0, 1.0, size=(m, n, batch))
    vis = (rng.random((m, n, batch)) > 0.2).astype(np.float64)
    vis[:, :, 4] = 0.0  # a scene with nothing visible
    return tuple(x.astype(dtype) for x in (params, u, v, vis))


def _plain(params, u, v, vis):
    err, grad = tk2.calibration_value_and_grad(*(torch.tensor(x) for x in (params, u, v, vis)))
    return err.numpy(), grad.numpy()


@pytest.mark.parametrize("m,n", [(4, 8), (3, 5)])
def test_plain_matches_pallas_kernel_f32(m, n):
    params, u, v, vis = _problem(0, 64, m, n, np.float32)
    j_err, j_grad = jk2.calibration_value_and_grad(
        *(jnp.asarray(x) for x in (params, u, v, vis)), block_b=64, interpret=True
    )
    t_err, t_grad = _plain(params, u, v, vis)
    np.testing.assert_allclose(t_err, np.asarray(j_err), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(t_grad, np.asarray(j_grad), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,n", [(4, 8), (2, 3), (4, 32), (3, 8)])
def test_plain_matches_vjp_f64(m, n):
    params, u, v, vis = _problem(1, 32, m, n)

    @jax.jit
    def value_and_vjp(q):
        err, pullback = jax.vjp(lambda x: j_objective(x, u, v, vis, approx_atan2=True), q)
        return err, pullback(jnp.ones_like(err))[0]

    err, j_grad = value_and_vjp(jnp.asarray(params.T))
    t_err, t_grad = _plain(params, u, v, vis)
    scale = float(np.max(np.abs(j_grad)))
    np.testing.assert_allclose(t_err, np.asarray(err), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_grad, np.asarray(j_grad).T, rtol=1e-10, atol=1e-10 * scale)


def test_plain_matches_torch_autograd_f64():
    params, u, v, vis = _problem(2, 32, 4, 8)
    x = torch.tensor(params.T.copy(), requires_grad=True)
    err = t_objective(x, *(torch.tensor(a) for a in (u, v, vis)), approx_atan2=True)
    (grad,) = torch.autograd.grad(err.sum(), x)
    t_err, t_grad = _plain(params, u, v, vis)
    scale = float(grad.abs().max())
    np.testing.assert_allclose(t_err, err.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_grad, grad.numpy().T, rtol=1e-10, atol=1e-10 * scale)


def test_fused_objective_closures():
    rng = np.random.default_rng(3)
    m, n, b = 4, 8, 16
    pts = rng.uniform(-1, 1, size=(b, m, n, 2))
    vis = rng.random((b, m, n)) > 0.2
    params = _problem(3, b, m, n)[0]
    t_err_fn, t_vg = tk2.make_fused_calibration_objective(torch.tensor(pts), torch.tensor(vis))
    j_err_fn, _ = jk2.make_fused_calibration_objective(jnp.asarray(pts), jnp.asarray(vis))
    j_err, j_grad = jax.jit(jax.value_and_grad(lambda q: j_err_fn(q).sum()))(jnp.asarray(params))
    np.testing.assert_allclose(t_err_fn(torch.tensor(params)).sum().numpy(), np.asarray(j_err), rtol=1e-12)
    err, grad = t_vg(torch.tensor(params))
    assert err.shape == (b,) and grad.shape == (b, params.shape[1])
    # the gradient of the exact-atan2 objective, to the polynomial's accuracy
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,n,taken", [(4, 8, True), (4, 32, True), (3, 8, True), (2, 128, True), (256, 1, True),
                                       (16, 17, False), (1, 8, False)])
def test_kernel_input_check_takes_every_scene_up_to_the_cap(m, n, taken):
    """The check the wrappers make before a launch on the card: every scene
    of M >= 2 views and N >= 1 points with M N <= 256 (eval-seq's default
    4 x 32 among them), a ValueError above the cap or below two views."""
    p = 3 + 3 * n + 6 * (m - 1)
    vectors = torch.zeros(5, p, dtype=torch.float32)
    obs = torch.zeros(m, n, 5, dtype=torch.float32)
    tensors = [("parameters", vectors), ("u_t", obs), ("v_t", obs), ("vis_t", obs)]
    if taken:
        assert tk2._check_kernel_inputs(tensors, obs) == (5, p)
    else:
        with pytest.raises(ValueError, match="M N <= 256"):
            tk2._check_kernel_inputs(tensors, obs)


def test_wrapper_rejects_unknown_device_layouts():
    params, u, v, vis = _problem(4, 8, 4, 8)
    with pytest.raises(ValueError):
        tk2.calibration_value_and_grad(*(torch.tensor(x, device="meta") for x in (params, u, v, vis)))
