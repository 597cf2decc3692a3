"""Parity of the port's stable trig ratios, guards and mask helpers with
the JAX package (float64 on the CPU).

Tolerances: values and first derivatives agree to 1e-12 relative (the two
implementations evaluate the same series and closed forms, so only
rounding differs); second derivatives to 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from davo_tpu.utils import guards as jguards
from davo_tpu.utils import masked as jmasked
from davo_tpu.utils import stable_trig as jtrig
from davo_tpu_torch.utils import guards as tguards
from davo_tpu_torch.utils import masked as tmasked
from davo_tpu_torch.utils import stable_trig as ttrig
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

RATIOS = ["sinc_sq", "one_minus_cos_sq", "cos_sin_sq", "sin_cubed_sq", "cos_from_sq"]
# zero, deep Taylor, both sides of both switch thresholds, and large angles
S_VALUES = np.array(
    [0.0, 1e-12, 1e-6, 0.0024, 0.0026, 0.06, 0.07, 0.3, 1.0, 2.5, 9.0, 30.0]
)


@pytest.mark.parametrize("name", RATIOS)
def test_ratio_values_and_derivatives(name):
    jfn, tfn = getattr(jtrig, name), getattr(ttrig, name)
    s_t = torch.tensor(S_VALUES, requires_grad=True)
    value = tfn(s_t)
    (d1,) = torch.autograd.grad(value.sum(), s_t, create_graph=True)
    (d2,) = torch.autograd.grad(d1.sum(), s_t)

    j_d1 = jax.vmap(jax.grad(jfn))(jnp.asarray(S_VALUES))
    j_d2 = jax.vmap(jax.grad(jax.grad(jfn)))(jnp.asarray(S_VALUES))
    np.testing.assert_allclose(value.detach().numpy(), jfn(jnp.asarray(S_VALUES)), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(d1.detach().numpy(), j_d1, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(d2.numpy(), j_d2, rtol=1e-10, atol=1e-13)
    assert np.all(np.isfinite(d2.numpy()))


@pytest.mark.parametrize("name", RATIOS)
def test_ratio_forward_mode_matches_jvp(name):
    jfn, tfn = getattr(jtrig, name), getattr(ttrig, name)
    tangent = np.linspace(-1.0, 2.0, S_VALUES.size)
    with fwAD.dual_level():
        out = tfn(fwAD.make_dual(torch.tensor(S_VALUES), torch.tensor(tangent)))
        _, t_out = fwAD.unpack_dual(out)
    _, j_out = jax.jvp(jfn, (jnp.asarray(S_VALUES),), (jnp.asarray(tangent),))
    np.testing.assert_allclose(t_out.numpy(), j_out, rtol=1e-12, atol=1e-15)


def test_safe_reciprocal_and_norm_at_zero():
    x = np.array([0.0, 2.0, -0.5])
    x_t = torch.tensor(x, requires_grad=True)
    r = tguards.safe_reciprocal(x_t)
    (g,) = torch.autograd.grad(r.sum(), x_t)
    np.testing.assert_allclose(r.detach().numpy(), jguards.safe_reciprocal(jnp.asarray(x)), rtol=1e-15)
    np.testing.assert_allclose(g.numpy(), jax.grad(lambda v: jguards.safe_reciprocal(v).sum())(jnp.asarray(x)))

    v = np.array([[0.0, 0.0, 0.0], [3.0, -4.0, 12.0]])
    v_t = torch.tensor(v, requires_grad=True)
    n = tguards.safe_norm(v_t)
    (gn,) = torch.autograd.grad(n.sum(), v_t)
    jn = lambda a: jguards.safe_norm(a).sum()  # noqa: E731
    np.testing.assert_allclose(n.detach().numpy(), jguards.safe_norm(jnp.asarray(v)), rtol=1e-15)
    np.testing.assert_allclose(gn.numpy(), jax.grad(jn)(jnp.asarray(v)), rtol=1e-14)
    assert np.all(gn.numpy()[0] == 0.0)

    sq = torch.tensor([0.0, 4.0], requires_grad=True)
    out = tguards.guarded_sqrt(sq)
    (gs,) = torch.autograd.grad(out.sum(), sq)
    np.testing.assert_allclose(out.detach().numpy(), [0.0, 2.0])
    np.testing.assert_allclose(gs.numpy(), jax.grad(lambda a: jguards.guarded_sqrt(a).sum())(jnp.asarray([0.0, 4.0])))


def test_inverse_curvature_skips_nonpositive_curvature(rng):
    s = rng.normal(size=(6, 5))
    y = rng.normal(size=(6, 5))
    y[:3] = -s[:3] * np.abs(rng.normal(size=(3, 5)))  # y.s < 0
    y[3] = 0.0  # y.s == 0
    s_t = torch.tensor(s, requires_grad=True)
    y_t = torch.tensor(y, requires_grad=True)
    inv = tguards.inverse_curvature(s_t, y_t)
    gs, gy = torch.autograd.grad(inv.sum(), (s_t, y_t))
    j_inv = jguards.inverse_curvature(jnp.asarray(s), jnp.asarray(y))
    j_gs, j_gy = jax.grad(lambda a, b: jguards.inverse_curvature(a, b).sum(), argnums=(0, 1))(
        jnp.asarray(s), jnp.asarray(y)
    )
    np.testing.assert_allclose(inv.detach().numpy(), j_inv, rtol=1e-13)
    np.testing.assert_allclose(gs.numpy(), j_gs, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(gy.numpy(), j_gy, rtol=1e-12, atol=1e-15)
    assert np.all(inv.detach().numpy()[:4] == 0.0)
    assert np.all(gs.numpy()[:4] == 0.0) and np.all(np.isfinite(gs.numpy()))
    # forward mode
    ts, ty = rng.normal(size=s.shape), rng.normal(size=y.shape)
    with fwAD.dual_level():
        out = tguards.inverse_curvature(
            fwAD.make_dual(torch.tensor(s), torch.tensor(ts)),
            fwAD.make_dual(torch.tensor(y), torch.tensor(ty)),
        )
        t_out = fwAD.unpack_dual(out).tangent
    _, j_t = jax.jvp(jguards.inverse_curvature, (jnp.asarray(s), jnp.asarray(y)), (jnp.asarray(ts), jnp.asarray(ty)))
    np.testing.assert_allclose(t_out.numpy(), j_t, rtol=1e-12, atol=1e-15)


def test_interpolate_alpha_values_and_grads():
    # secant inside the bracket, secant outside (bisection), equal values
    a1 = np.array([0.0, 0.0, 0.2, 1.0])
    a2 = np.array([1.0, 1.0, 0.8, 2.0])
    v1 = np.array([-1.0, -1.0, 0.5, 0.3])
    v2 = np.array([1.0, 0.001, 0.5, -0.9])
    args_t = [torch.tensor(x, requires_grad=True) for x in (a1, a2, v1, v2)]
    out = tguards.interpolate_alpha(*args_t)
    grads = torch.autograd.grad(out.sum(), args_t)
    args_j = [jnp.asarray(x) for x in (a1, a2, v1, v2)]
    np.testing.assert_allclose(out.detach().numpy(), jguards.interpolate_alpha(*args_j), rtol=1e-14)
    j_grads = jax.grad(lambda *a: jguards.interpolate_alpha(*a).sum(), argnums=(0, 1, 2, 3))(*args_j)
    for g, jg in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("has_v1", [False, True])
@pytest.mark.parametrize("has_v2", [False, True])
@pytest.mark.parametrize("m1", [False, True])
@pytest.mark.parametrize("m2", [False, True])
def test_masked_merge_tensors_matches(rng, has_v1, has_v2, m1, m2):
    v1, v2 = rng.normal(size=(6, 2)), rng.normal(size=(6, 2))
    k1, k2, upd = rng.random(6) > 0.5, rng.random(6) > 0.5, rng.random(6) > 0.5
    jargs = (
        jnp.asarray(v1) if has_v1 else None,
        jnp.asarray(k1) if m1 else None,
        jnp.asarray(v2) if has_v2 else None,
        jnp.asarray(k2) if m2 else None,
        jnp.asarray(upd[:, None] if has_v1 and has_v2 else upd),
    )
    targs = tuple(None if a is None else torch.tensor(np.asarray(a)) for a in jargs)
    for j, t in zip(jmasked.masked_merge_tensors(*jargs), tmasked.masked_merge_tensors(*targs)):
        assert (j is None) == (t is None)
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_masked_update_broadcasts_trailing_dims(rng):
    cur, new = rng.normal(size=(4, 3, 2)), rng.normal(size=(4, 3, 2))
    mask = rng.random(4) > 0.5
    out = tmasked.masked_update(torch.tensor(cur), torch.tensor(new), torch.tensor(mask))
    np.testing.assert_array_equal(out.numpy(), jmasked.masked_update(cur, new, mask))
