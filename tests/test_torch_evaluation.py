"""The trajectory and intrinsics metrics (``train/evaluation.py``) against
the JAX package's, in float64 on the same numpy inputs.

The JAX functions take one scene; the port's take leading batch
dimensions, held here against ``jax.vmap`` of the JAX ones.  Tolerance
1e-10 (the same algebra; the SVD of the Umeyama alignment is unique up to
signs that the rotation does not see, with distinct singular values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.train import evaluation as je
from davo_tpu_torch.train import evaluation as te
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

TOL = dict(rtol=1e-10, atol=1e-10)


def _poses(rng, batch, k):
    orientations = rng.normal(size=(batch, k, 3))
    orientations[:, 0] = 0.0  # the identity, as view 1 of every scene
    translations = 3.0 * rng.normal(size=(batch, k, 3))
    return orientations, translations


def test_camera_centers_from_poses():
    o, t = _poses(np.random.default_rng(0), 5, 4)
    expected = je.camera_centers_from_poses(jnp.asarray(o), jnp.asarray(t))
    got = te.camera_centers_from_poses(torch.tensor(o), torch.tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **TOL)


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_alignment(with_scale):
    rng = np.random.default_rng(1)
    source = rng.normal(size=(6, 5, 3))
    target = 2.0 * source[..., ::-1] + rng.normal(size=(6, 5, 3)) * 0.1 + 1.0  # a reflection to undo
    expected = jax.vmap(lambda s, t: je.umeyama_alignment(s, t, with_scale))(jnp.asarray(source), jnp.asarray(target))
    got = te.umeyama_alignment(torch.tensor(source), torch.tensor(target), with_scale)
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **TOL)


@pytest.mark.parametrize("align", [True, False])
def test_absolute_trajectory_error(align):
    rng = np.random.default_rng(2)
    true = rng.normal(size=(7, 4, 3))
    est = 0.5 * true @ np.linalg.qr(rng.normal(size=(3, 3)))[0] + 0.05 * rng.normal(size=(7, 4, 3))
    expected = jax.vmap(lambda e, t: je.absolute_trajectory_error(e, t, align))(jnp.asarray(est), jnp.asarray(true))
    got = te.absolute_trajectory_error(torch.tensor(est), torch.tensor(true), align)
    assert set(got) == set(expected)
    for name in expected:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(expected[name]), **TOL)


@pytest.mark.parametrize("delta", [1, 2])
def test_relative_pose_error(delta):
    rng = np.random.default_rng(3)
    o, t = _poses(rng, 1, 6)
    true = np.concatenate([o[0], t[0]], axis=-1)
    est = true + 0.05 * rng.normal(size=true.shape)
    expected = je.relative_pose_error(jnp.asarray(est), jnp.asarray(true), delta)
    got = te.relative_pose_error(torch.tensor(est), torch.tensor(true), delta)
    assert set(got) == set(expected)
    for name in expected:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(expected[name]), **TOL)
    with pytest.raises(ValueError):
        te.relative_pose_error(torch.tensor(est), torch.tensor(true), 6)


def test_intrinsics_error():
    rng = np.random.default_rng(4)
    est, true = rng.normal(size=(9, 3)), rng.normal(size=(9, 3))
    expected = je.intrinsics_error(jnp.asarray(est), jnp.asarray(true))
    got = te.intrinsics_error(torch.tensor(est), torch.tensor(true))
    assert set(got) == set(expected)
    for name in expected:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(expected[name]), **TOL)
