"""Kernel K3's plain versions against the JAX package's attention.

* :func:`reference_flash_attention` (K3's function) against the JAX Pallas
  kernel ``flash_match_attention`` run in interpret mode with small blocks
  (``block_q=8, block_k=16``), so Q and K are not multiples of the blocks
  and the online softmax crosses several key blocks: float32 to 1e-5.
  The JAX kernel takes its dot products in float32 whatever the input
  type (``preferred_element_type=jnp.float32``), so in float64 the plain
  version is held against it to 1e-6 and against the JAX package's exact
  ``_reference_attention`` to 1e-12 on every row with a valid key.  Rows
  with no valid key are exactly zero on both sides.
* :func:`reference_attention` against ``_reference_attention``, every row
  (a row with no valid key returns the mean of ``value``): float32 1e-5,
  float64 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.ops.attention import _reference_attention as j_reference_attention
from davo_tpu.ops.attention import flash_match_attention as j_flash_match_attention
from davo_tpu_torch.ops import attention
from davo_tpu_torch.ops import build
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

SHAPES = [  # (B, Q, K, D, C)
    (2, 13, 37, 8, 2),
    (3, 21, 50, 16, 2),
    (1, 9, 16, 4, 3),
]


def _inputs(seed, b, q_len, kv_len, d, c, dtype):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, q_len, d)).astype(dtype)
    k = rng.normal(size=(b, kv_len, d)).astype(dtype)
    v = rng.normal(size=(b, kv_len, c)).astype(dtype)
    mask = rng.random((b, kv_len)) > 0.35
    mask[0] = False  # problem 0: no row has a valid key
    if kv_len > 32:
        mask[-1, 16:32] = False  # a whole key block masked
    return q, k, v, mask


def _jax_kernel(q, k, v, mask):
    out = j_flash_match_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask),
        interpret=True, block_q=8, block_k=16,
    )
    return np.asarray(out)


def _port(fn, q, k, v, mask):
    return fn(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), None if mask is None else torch.tensor(mask)
    ).numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("masked", [False, True])
def test_plain_k3_matches_the_pallas_kernel_f32(shape, masked):
    q, k, v, mask = _inputs(sum(shape), *shape, np.float32)
    mask = mask if masked else None
    expected = _jax_kernel(q, k, v, mask)
    got = _port(attention.reference_flash_attention, q, k, v, mask)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)
    if masked:
        assert np.all(got[0] == 0.0) and np.all(expected[0] == 0.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_k3_matches_jax_f64(shape):
    q, k, v, mask = _inputs(sum(shape) + 1, *shape, np.float64)
    got = _port(attention.reference_flash_attention, q, k, v, mask)
    assert got.dtype == np.float64
    # the Pallas kernel's dots are float32
    np.testing.assert_allclose(got, _jax_kernel(q, k, v, mask), rtol=1e-6, atol=1e-6)
    exact = np.asarray(j_reference_attention(*(jnp.asarray(x) for x in (q, k, v, mask))))
    has_key = mask.any(axis=1)
    np.testing.assert_allclose(got[has_key], exact[has_key], rtol=1e-12, atol=1e-12)
    assert np.all(got[~has_key] == 0.0)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
@pytest.mark.parametrize("masked", [False, True])
def test_reference_attention_matches_jax(dtype, tol, masked):
    q, k, v, mask = _inputs(7, 2, 11, 29, 8, 2, dtype)
    mask = mask if masked else None
    expected = np.asarray(
        j_reference_attention(*(jnp.asarray(x) for x in (q, k, v)), None if mask is None else jnp.asarray(mask))
    )
    got = _port(attention.reference_attention, q, k, v, mask)
    np.testing.assert_allclose(got, expected, rtol=tol, atol=tol)
    if masked:  # no valid key: the mean of the values, not zeros
        np.testing.assert_allclose(got[0], np.broadcast_to(v[0].mean(axis=0), got[0].shape), rtol=tol, atol=tol)


def test_match_attention_on_cpu_takes_the_plain_k3():
    q, k, v, mask = _inputs(3, 2, 10, 20, 8, 2, np.float64)
    before = dict(build.launch_counts)
    got = _port(attention.match_attention, q, k, v, mask)
    np.testing.assert_array_equal(got, _port(attention.reference_flash_attention, q, k, v, mask))
    assert build.launch_counts == before  # the plain version launches nothing
    # a 4-D query goes to the JAX package's jnp form, as there
    q4, k4, v4 = (torch.tensor(x)[None] for x in (q, k, v))
    got4 = attention.match_attention(q4, k4, v4).numpy()
    expected4 = np.asarray(j_reference_attention(*(jnp.asarray(x)[None] for x in (q, k, v))))
    np.testing.assert_allclose(got4, expected4, rtol=1e-12, atol=1e-12)


def test_flash_match_attention_refuses_mismatched_shapes():
    q = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError):
        attention.flash_match_attention(q, torch.zeros(2, 6, 7), torch.zeros(2, 6, 2))
    with pytest.raises(ValueError):
        attention.flash_match_attention(q, torch.zeros(2, 6, 8), torch.zeros(2, 6, 2), torch.ones(2, 5, dtype=torch.bool))
