"""Kernels K1, K1′, K2, K3 and K4 on the card, against their plain PyTorch
versions.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips elsewhere.
The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -o addopts= -m gpu

(``--noconftest``: the suite's conftest configures JAX).  Tolerances,
float32 on both sides, normwise (max |a - b| / max(1, max |b|)): K1 1e-4
(bfloat16 H: 1e-2, one rounding of the stored H), K2 values 1e-5 and
gradients 1e-4, K3 1e-5 with rows that have no valid key exactly zero (its
QK^T on the tensor cores as three TF32 products, float32 accuracy), K1′
as K1, K4 values 1e-5 and directional derivatives 1e-4.
"""

import numpy as np
import pytest
import torch

from davo_tpu_torch.ops import build
from davo_tpu_torch.ops import attention as k3
from davo_tpu_torch.ops import bfgs_update as k1
from davo_tpu_torch.ops import bfgs_update_variants as k1v
from davo_tpu_torch.ops import calibration_obj as k2
from tests.torch_port_helpers import cuda_device  # noqa: F401

FLAGS = [(True, False), (False, True), (False, False)]


def _normwise(actual, expected):
    actual, expected = actual.float().cpu(), expected.float().cpu()
    return float((actual - expected).abs().max() / max(1.0, float(expected.abs().max())))


def _k1_inputs(b, p, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(b, p, p, generator=g) / p**0.5
    h = torch.eye(p) + a @ a.transpose(1, 2)
    s = 0.1 * torch.randn(b, p, generator=g)
    c = torch.randn(b, p, p, generator=g) / p**0.5
    y = torch.einsum("bij,bj->bi", torch.eye(p) + c @ c.transpose(1, 2), s)  # y.s > 0
    y[: b // 10] = -s[: b // 10]  # y.s <= 0: update skipped
    grad = torch.randn(b, p, generator=g)
    updating = torch.rand(b, generator=g) > 0.3
    return h.permute(1, 2, 0).contiguous(), s, y, grad, updating


@pytest.mark.gpu
@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "p",
    [45, 27, 48, 49],  # the register route (P <= 48: 3 views x 4 points, its ceiling) and the two-pass one above
)
def test_bfgs_update_kernel_matches_plain(cuda_device, h_dtype, p):
    h_t, s, y, grad, updating = _k1_inputs(1000, p)  # a ragged last block (16 and 32 elements a block)
    h_t = h_t.to(h_dtype)
    on_card = [x.to(cuda_device) for x in (h_t, s, y, grad, updating)]
    for first, second in FLAGS:
        before = build.launch_counts["bfgs_update"]
        k_h, k_d = k1.fused_bfgs_update_direction(*on_card, first, second)
        torch.cuda.synchronize()
        assert build.launch_counts["bfgs_update"] == before + 1
        p_h, p_d = k1.fused_bfgs_update_direction(h_t, s, y, grad, updating, first, second)
        assert _normwise(k_h, p_h) <= (1e-2 if h_dtype == torch.bfloat16 else 1e-4)
        assert _normwise(k_d, p_d) <= 1e-4


@pytest.mark.gpu
def test_bfgs_update_kernel_takes_a_bf16_carry_at_an_odd_element(cuda_device):
    """A contiguous bfloat16 H that starts at an odd element (2 bytes past a
    4-byte boundary) at an even B: no packed pair may be loaded from it."""
    h_t, s, y, grad, updating = _k1_inputs(64, 45)
    h_t = h_t.to(torch.bfloat16)
    buf = torch.empty(h_t.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
    h_odd = buf[1:].view(h_t.shape)
    h_odd.copy_(h_t)
    assert h_odd.is_contiguous() and h_odd.data_ptr() % 4 == 2
    on_card = [x.to(cuda_device) for x in (s, y, grad, updating)]
    for first, second in FLAGS:
        k_h, k_d = k1.fused_bfgs_update_direction(h_odd, *on_card, first, second)
        torch.cuda.synchronize()
        p_h, p_d = k1.fused_bfgs_update_direction(h_t, s, y, grad, updating, first, second)
        assert _normwise(k_h, p_h) <= 1e-2
        assert _normwise(k_d, p_d) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("ordering", [k1v.rowloop_update_direction, k1v.rowloop2_update_direction])
@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("elements_per_block", k1v.ELEMENTS_PER_BLOCK)
def test_bfgs_update_variant_kernel_matches_plain(cuda_device, ordering, h_dtype, elements_per_block):
    h_t, s, y, grad, updating = _k1_inputs(1000, 45)  # a ragged last block
    h_t = h_t.to(h_dtype)
    on_card = [x.to(cuda_device) for x in (h_t, s, y, grad, updating)]
    name = "bfgs_update_rowloop" if ordering is k1v.rowloop_update_direction else "bfgs_update_rowloop2"
    for first, second in FLAGS:
        before = build.launch_counts[name]
        k_h, k_d = ordering(*on_card, first, second, elements_per_block=elements_per_block)
        torch.cuda.synchronize()
        assert build.launch_counts[name] == before + 1
        p_h, p_d = ordering(h_t, s, y, grad, updating, first, second)
        assert _normwise(k_h, p_h) <= (1e-2 if h_dtype == torch.bfloat16 else 1e-4)
        assert _normwise(k_d, p_d) <= 1e-4


def _objective_inputs(b, m=4, n=8):
    rng = np.random.default_rng(1)
    p = 3 + 3 * n + 6 * (m - 1)
    params = 0.3 * rng.normal(size=(b, p))
    params[:, 0] += rng.normal(size=b)
    params[:, 5 : 3 + 3 * n : 3] += 1.0
    params[:50, 3 + 3 * n + 3 * (m - 1) :] *= 1e-3  # the Taylor branches
    params[1::9, 0] = -np.abs(params[1::9, 0])  # f <= 0: the exp branch
    u = rng.uniform(-1, 1, size=(m, n, b))
    v = rng.uniform(-1, 1, size=(m, n, b))
    vis = (rng.random((m, n, b)) > 0.2).astype(np.float64)
    vis[2, :, 3::11] = 0.0  # a view with nothing visible
    vis[:, :, 7:8] = 0.0  # an element with nothing visible (where b > 7)
    direction = rng.normal(size=(b, p))
    return [torch.tensor(x, dtype=torch.float32) for x in (params, u, v, vis, direction)]


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1000, 1003, 5])  # whole blocks of 8 elements; a ragged last one; one block
def test_calibration_value_and_grad_kernel_matches_plain(cuda_device, b):
    params, u, v, vis, _ = _objective_inputs(b)
    on_cpu = [params, u, v, vis]
    before = build.launch_counts["calibration_value_and_grad"]
    k_err, k_grad = k2.calibration_value_and_grad(*(x.to(cuda_device) for x in on_cpu))
    torch.cuda.synchronize()
    assert build.launch_counts["calibration_value_and_grad"] == before + 1
    p_err, p_grad = k2.calibration_value_and_grad(*on_cpu)
    assert _normwise(k_err, p_err) <= 1e-5
    assert _normwise(k_grad, p_grad) <= 1e-4
    if b > 7:
        assert float(k_err[7]) == 0.0  # nothing visible


@pytest.mark.gpu
def test_calibration_value_and_dirderiv_kernel_matches_plain(cuda_device):
    params, u, v, vis, direction = _objective_inputs(1000)  # a ragged last block
    on_cpu = [params, direction, u, v, vis]
    before = build.launch_counts["calibration_value_and_dirderiv"]
    k_err, k_dphi = k2.calibration_value_and_dirderiv(*(x.to(cuda_device) for x in on_cpu))
    torch.cuda.synchronize()
    assert build.launch_counts["calibration_value_and_dirderiv"] == before + 1
    p_err, p_dphi = k2.calibration_value_and_dirderiv(*on_cpu)
    assert _normwise(k_err, p_err) <= 1e-5
    assert _normwise(k_dphi, p_dphi) <= 1e-4
    assert float(k_err[7]) == 0.0 and float(k_dphi[7]) == 0.0  # nothing visible


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 8191, 16384])  # one block of 8 warps; a ragged last block; the bench batch
def test_calibration_value_and_dirderiv_kernel_at_served_batches(cuda_device, b):
    """K4 one warp per element, with chip_smoke.py's edges: an element that
    sees nothing reads exactly 0 and 0, and f = 0 (the exp branch's edge)."""
    params, u, v, vis, direction = _objective_inputs(b)
    params[1, 0] = 0.0
    on_cpu = [params, direction, u, v, vis]
    before = build.launch_counts["calibration_value_and_dirderiv"]
    k_err, k_dphi = k2.calibration_value_and_dirderiv(*(x.to(cuda_device) for x in on_cpu))
    torch.cuda.synchronize()
    assert build.launch_counts["calibration_value_and_dirderiv"] == before + 1
    p_err, p_dphi = k2.calibration_value_and_dirderiv(*on_cpu)
    assert _normwise(k_err, p_err) <= 1e-5
    assert _normwise(k_dphi, p_dphi) <= 1e-4
    assert float(k_err[7]) == 0.0 and float(k_dphi[7]) == 0.0  # nothing visible


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    h_t, s, y, grad, updating = (x.to(cuda_device) for x in _k1_inputs(64, 7))
    with pytest.raises(ValueError):  # float64 H
        k1.fused_bfgs_update_direction(h_t.double(), s, y, grad, updating, False, False)
    with pytest.raises(ValueError):  # 8 elements per block is not compiled
        k1v.rowloop2_update_direction(h_t, s, y, grad, updating, False, False, elements_per_block=8)
    x = torch.zeros(64, 24, device=cuda_device)  # (M, N) = (3, 3) is not compiled
    obs = torch.zeros(3, 3, 64, device=cuda_device)
    with pytest.raises(ValueError):
        k2.calibration_value_and_grad(x, obs, obs, obs)
    with pytest.raises(ValueError):
        k2.calibration_value_and_dirderiv(x, x, obs, obs, obs)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,q_len,kv_len,d,c",
    [
        (96, 144, 144, 64, 2),
        (5, 70, 90, 40, 3),
        (3, 9, 200, 100, 8),
        (3072, 144, 144, 64, 2),  # the matcher's shape
        (64, 37, 211, 100, 8),  # five key tiles, D = 100, C = 8
        (4, 30, 50, 37, 2),  # D % 4 != 0: rows staged by 4-byte copies
    ],
)
def test_match_attention_kernel_matches_plain(cuda_device, b, q_len, kv_len, d, c):
    g = torch.Generator().manual_seed(q_len + d)
    q = torch.randn(b, q_len, d, generator=g)
    k = torch.randn(b, kv_len, d, generator=g)
    v = torch.randn(b, kv_len, c, generator=g)
    mask = torch.rand(b, kv_len, generator=g) > 0.3
    mask[0] = False  # problem 0: every row without a valid key
    for m in (None, mask):
        before = build.launch_counts["match_attention"]
        got = k3.flash_match_attention(*(x.to(cuda_device) for x in (q, k, v)), None if m is None else m.to(cuda_device))
        torch.cuda.synchronize()
        assert build.launch_counts["match_attention"] == before + 1
        expected = k3.flash_match_attention(q, k, v, m)
        assert _normwise(got, expected) <= 1e-5
        if m is not None:
            assert bool(torch.all(got[0] == 0))
