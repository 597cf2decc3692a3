"""Kernel K1 (fused BFGS update + direction): the port's plain version
against the JAX package's Pallas kernel.  The CUDA kernel itself is held
against the plain version in ``test_torch_gpu.py`` (on the card) and
``test_torch_csrc_host.py`` (its source, compiled for the host).

Tolerances: float32 against the interpreted Pallas kernel rtol 1e-5
(atol 1e-5: sums over P = 7 terms of O(1) values round in another order);
float64 against the JAX reference algebra 1e-12; bfloat16 storage
against the Pallas kernel with bfloat16 storage: one bfloat16 rounding of
the stored H (rtol 1e-2), and the direction, computed before rounding,
rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.ops import bfgs_update as jk1
from davo_tpu_torch.ops import bfgs_update as tk1
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

FLAGS = [(False, False), (True, False), (False, True)]


def _case(seed, b=256, p=7, dtype=np.float32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(b, p, p))
    h = (a @ np.swapaxes(a, 1, 2) / p + np.eye(p)).astype(dtype)  # symmetric
    s = (0.1 * rng.normal(size=(b, p))).astype(dtype)
    y = (0.1 * rng.normal(size=(b, p))).astype(dtype)
    k = b // 4  # non-positive curvature: update skipped
    y[:k] = -s[:k] * np.abs(rng.normal(size=(k, p))).astype(dtype)
    g = rng.normal(size=(b, p)).astype(dtype)
    upd = rng.random(b) > 0.3
    return h, s, y, g, upd


def _torch_plain(h, s, y, g, upd, first, second, h_dtype=torch.float32):
    h_t = torch.tensor(np.transpose(h, (1, 2, 0)).copy()).to(h_dtype)
    out_t, d = tk1.fused_bfgs_update_direction(
        h_t, torch.tensor(s), torch.tensor(y), torch.tensor(g), torch.tensor(upd), first, second
    )
    if out_t.dtype == torch.bfloat16:
        out_t = out_t.float()
    return out_t.numpy(), d.numpy()


@pytest.mark.parametrize("first,second", FLAGS)
def test_plain_matches_pallas_kernel_f32(first, second):
    h, s, y, g, upd = _case(0)
    j_h, j_d = jk1.fused_bfgs_update_direction(
        jnp.asarray(np.transpose(h, (1, 2, 0))),
        jnp.asarray(s), jnp.asarray(y), jnp.asarray(g), jnp.asarray(upd),
        jnp.asarray(first), jnp.asarray(second), interpret=True,
    )
    t_h, t_d = _torch_plain(h, s, y, g, upd, first, second)
    np.testing.assert_allclose(t_h, np.asarray(j_h), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_d, np.asarray(j_d), rtol=1e-5, atol=1e-5)


def test_plain_matches_pallas_kernel_bf16_storage():
    h, s, y, g, upd = _case(1)
    h_bf16 = jnp.asarray(np.transpose(h, (1, 2, 0))).astype(jnp.bfloat16)
    j_h, j_d = jk1.fused_bfgs_update_direction(
        h_bf16, jnp.asarray(s), jnp.asarray(y), jnp.asarray(g), jnp.asarray(upd),
        jnp.asarray(False), jnp.asarray(True), interpret=True,
    )
    h_in = np.transpose(np.asarray(h_bf16.astype(jnp.float32)), (2, 0, 1))
    t_h, t_d = _torch_plain(h_in, s, y, g, upd, False, True, torch.bfloat16)
    np.testing.assert_allclose(t_h, np.asarray(j_h.astype(jnp.float32)), rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(t_d, np.asarray(j_d), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("first,second", FLAGS)
def test_reference_algebra_matches_jax_f64(first, second):
    h, s, y, g, upd = _case(2, dtype=np.float64)
    j_h, j_d = jk1.reference_update_direction(
        jnp.asarray(h), jnp.asarray(s), jnp.asarray(y), jnp.asarray(g), jnp.asarray(upd),
        jnp.asarray(first), jnp.asarray(second),
    )
    t_h, t_d = tk1.reference_update_direction(
        torch.tensor(h), torch.tensor(s), torch.tensor(y), torch.tensor(g), torch.tensor(upd),
        first, second,
    )
    np.testing.assert_allclose(t_h.numpy(), np.asarray(j_h), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(t_d.numpy(), np.asarray(j_d), rtol=1e-12, atol=1e-12)


def test_negative_curvature_skips_update():
    h, s, y, g, upd = _case(3, dtype=np.float64)
    t_h, t_d = _torch_plain(h, s, -s, g, upd, False, False, torch.float64)
    np.testing.assert_array_equal(t_h, np.transpose(h, (1, 2, 0)))
    np.testing.assert_allclose(t_d, -np.einsum("bij,bj->bi", h, g), rtol=1e-12)


def test_wrapper_rejects_bad_shapes():
    h, s, y, g, upd = _case(4)
    with pytest.raises(ValueError):
        tk1.fused_bfgs_update_direction(
            torch.tensor(h), torch.tensor(s), torch.tensor(y), torch.tensor(g),
            torch.tensor(upd), False, False,
        )
