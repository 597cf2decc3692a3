"""Kernel K1′ (the BFGS-update tuning variants): the plain versions of the
``rowloop`` and ``rowloop2`` orderings against the JAX package.

Each ordering's plain version is held against
* the TPU kernel it ports, ``rowloop_kernel`` / ``rowloop2_kernel`` of
  ``scripts/tune_bfgs_kernel.py`` (loaded with importlib and wrapped here
  in a ``pl.pallas_call`` of our own, interpreted, at B = 256 in blocks of
  128 and P = 45, as the script's ``build`` wraps them), and
* JAX's K1, ``fused_bfgs_update_direction(interpret=True)``,

for the first, second and later steps, with H stored float32 or bfloat16.
The CUDA kernel itself is held against the plain versions in
``test_torch_gpu.py`` (on the card) and ``test_torch_csrc_host.py`` (its
source, compiled for the host).

The TPU kernels reduce yᵀH over the rows on their own; they do not take it
from Hy by symmetry, as K1 does.  The carry of a solve drifts from exact
symmetry by rounding, so each ordering is also held against its TPU
kernel on a carry that is not symmetric, H + 0.05 N with N a seeded
normal matrix.

Tolerances, float32 on both sides, normwise (max |a - b| / max(1, max |b|)):
1e-5 for H+ and d against the ordering's own TPU kernel (the same
arithmetic, sums in another order), 1e-4 against JAX's K1 (the other
ordering of the rescale); with bfloat16 H, 1e-2 on H+ (one rounding of
the stored H) and 1e-4 on d.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from davo_tpu.ops.bfgs_update import fused_bfgs_update_direction as j_fused
from davo_tpu_torch.ops import bfgs_update_variants as k1v
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

B, P, BLOCK = 256, 45, 128
STEPS = [(True, False), (False, True), (False, False)]
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "tune_bfgs_kernel.py"


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("tune_bfgs_kernel_script", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _pallas(kernel, h_dtype):
    """The script's ``build`` at B = 256, interpreted."""
    vec = pl.BlockSpec((P, BLOCK), lambda i: (0, i), memory_space=pltpu.VMEM)
    h_spec = pl.BlockSpec((P, P, BLOCK), lambda i: (0, 0, i), memory_space=pltpu.VMEM)

    @jax.jit
    def op(h_t, s_t, y_t, g_t, upd, flags):
        return pl.pallas_call(
            kernel,
            out_shape=(jax.ShapeDtypeStruct((P, P, B), h_dtype), jax.ShapeDtypeStruct((P, B), jnp.float32)),
            grid=(B // BLOCK,),
            in_specs=[
                pl.BlockSpec((1, 2), lambda i: (0, 0), memory_space=pltpu.SMEM),
                h_spec, vec, vec, vec,
                pl.BlockSpec((1, BLOCK), lambda i: (0, i), memory_space=pltpu.VMEM),
            ],
            out_specs=(h_spec, vec),
            interpret=True,
        )(flags, h_t, s_t, y_t, g_t, upd)

    return op


def _inputs(seed=0, asymmetry=0.0):
    """Symmetric positive-definite H (plus ``asymmetry`` times a normal
    matrix that is not symmetric), curvature pairs, a mixed mask."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(B, P, P)) / np.sqrt(P)
    h = np.eye(P) + a @ a.transpose(0, 2, 1)
    if asymmetry:
        h = h + asymmetry * np.random.default_rng(seed + 100).normal(size=(B, P, P))
    s = 0.1 * rng.normal(size=(B, P))
    c = rng.normal(size=(B, P, P)) / np.sqrt(P)
    y = np.einsum("bij,bj->bi", np.eye(P) + c @ c.transpose(0, 2, 1), s)  # y.s > 0
    y[:16] = -s[:16]  # y.s <= 0: update skipped
    g = rng.normal(size=(B, P))
    upd = rng.random(B) > 0.3
    h_t = np.ascontiguousarray(h.transpose(1, 2, 0), dtype=np.float32)
    return h_t, *(x.astype(np.float32) for x in (s, y, g)), upd


def _normwise(actual, expected):
    actual, expected = np.asarray(actual, np.float64), np.asarray(expected, np.float64)
    return np.max(np.abs(actual - expected)) / max(1.0, np.max(np.abs(expected)))


def _plain(ordering, h_t, s, y, g, upd, first, second, h_dtype):
    """The port's wrapper on CPU tensors: the ordering's plain version."""
    h = torch.tensor(h_t).to(h_dtype)
    h_out, d = ordering(h, *(torch.tensor(x) for x in (s, y, g, upd)), first, second)
    return h_out.float().numpy(), d.numpy()


# the script's rowloop_kernel stores its float32 rows into the H block
# without a cast, which Pallas refuses for a bfloat16 block (the script
# sweeps rowloop with float32 H only); rowloop with bfloat16 H is held
# against JAX's K1 below
@pytest.mark.parametrize(
    "name,h_dtype", [("rowloop", torch.float32), ("rowloop2", torch.float32), ("rowloop2", torch.bfloat16)]
)
def test_plain_matches_script_kernel(script, name, h_dtype):
    _check_against_script_kernel(script, name, h_dtype, _inputs())


@pytest.mark.parametrize(
    "name,h_dtype", [("rowloop", torch.float32), ("rowloop2", torch.float32), ("rowloop2", torch.bfloat16)]
)
def test_plain_matches_script_kernel_on_a_nonsymmetric_carry(script, name, h_dtype):
    """H + 0.05 N: both sides reduce yᵀH over the rows, so they agree as on
    a symmetric carry; a plain version that took yᵀH = (Hy)ᵀ would not."""
    h_t, s, y, g, upd = _inputs(3, asymmetry=0.05)
    assert np.max(np.abs(h_t - h_t.transpose(1, 0, 2))) > 0.1
    _check_against_script_kernel(script, name, h_dtype, (h_t, s, y, g, upd))


def _check_against_script_kernel(script, name, h_dtype, inputs):
    j_dtype = jnp.bfloat16 if h_dtype == torch.bfloat16 else jnp.float32
    ordering = k1v.rowloop_update_direction if name == "rowloop" else k1v.rowloop2_update_direction
    op = _pallas(getattr(script, f"{name}_kernel"), j_dtype)
    h_t, s, y, g, upd = inputs
    h_in = jnp.asarray(h_t).astype(j_dtype)
    h_plain_in = np.asarray(h_in.astype(jnp.float32))
    for first, second in STEPS:
        flags = jnp.asarray([[float(first), float(second)]], jnp.float32)
        j_h, j_d = op(h_in, *(jnp.asarray(x.T) for x in (s, y, g)), jnp.asarray(upd, jnp.float32)[None], flags)
        t_h, t_d = _plain(ordering, h_plain_in, s, y, g, upd, first, second, h_dtype)
        assert _normwise(t_h, np.asarray(j_h.astype(jnp.float32))) <= (1e-2 if h_dtype == torch.bfloat16 else 1e-5)
        assert _normwise(t_d, np.asarray(j_d).T) <= 1e-5


@pytest.fixture(scope="module")
def jax_k1():
    """JAX's K1 (interpreted) on ``_inputs(1)`` for each H type and step,
    computed once for both orderings' tests."""
    h_t, s, y, g, upd = _inputs(1)
    fused = jax.jit(lambda h, s, y, g, u, f, sc: j_fused(h, s, y, g, u, f, sc, block_b=BLOCK, interpret=True))
    results = {}
    for h_dtype, j_dtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        h_in = jnp.asarray(h_t).astype(j_dtype)
        for first, second in STEPS:
            j_h, j_d = fused(h_in, *(jnp.asarray(x) for x in (s, y, g, upd)), jnp.asarray(first), jnp.asarray(second))
            results[h_dtype, first, second] = (np.asarray(h_in.astype(jnp.float32)), j_h, j_d)
    return results


@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["rowloop", "rowloop2"])
def test_plain_matches_jax_k1(jax_k1, name, h_dtype):
    ordering = k1v.rowloop_update_direction if name == "rowloop" else k1v.rowloop2_update_direction
    _, s, y, g, upd = _inputs(1)
    for first, second in STEPS:
        h_plain_in, j_h, j_d = jax_k1[h_dtype, first, second]
        t_h, t_d = _plain(ordering, h_plain_in, s, y, g, upd, first, second, h_dtype)
        assert _normwise(t_h, np.asarray(j_h.astype(jnp.float32))) <= (1e-2 if h_dtype == torch.bfloat16 else 1e-4)
        assert _normwise(t_d, np.asarray(j_d)) <= 1e-4


def test_orderings_round_differently():
    """The two orderings agree to float32 rounding, not bit for bit, on the
    second step (where the rescale applies)."""
    h_t, s, y, g, upd = _inputs(2)
    args = (torch.tensor(h_t), *(torch.tensor(x) for x in (s, y, g, upd)), False, True)
    h1, d1 = k1v.rowloop_update_direction(*args)
    h2, d2 = k1v.rowloop2_update_direction(*args)
    assert _normwise(h1.numpy(), h2.numpy()) <= 1e-5 and _normwise(d1.numpy(), d2.numpy()) <= 1e-5
    assert not torch.equal(h1, h2)


def test_wrappers_refuse_unsupported_blocks():
    h_t, s, y, g, upd = _inputs()
    with pytest.raises(ValueError, match="elements_per_block"):
        k1v.rowloop2_update_direction(
            torch.tensor(h_t), *(torch.tensor(x) for x in (s, y, g, upd)), False, False, elements_per_block=8
        )
