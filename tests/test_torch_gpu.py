"""Kernels K1, K1′, K2, K3 and K4 on the card, against their plain PyTorch
versions (also at vo-eval's shapes: K1 and K2 at a bootstrap solve's 8
elements, K3 at 15 and 3 problems; K1 at the windows pipeline's stacked
56 elements and at correct_scale_drift's P = 15, B = 1); one training step of the calibration
network and one of the front end on the card against the CPU's; the
L-BFGS eval solve on the card (through K2) against the CPU's; and the
incremental-VO accumulator on clean inputs, the card in float32 against
the CPU in float64; the windows pipeline's oracle-guess recovery on
the card; the distorted calibration's LM on the card against the CPU
(float64, 1e-9) and ``eval-distorted``; sequential tracking, K3 at 8
and 32 track queries against 144 cells; and the Orbax writer on CUDA
tensors.

Every test here needs an NVIDIA GPU with ``nvcc`` and skips elsewhere.
The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -o addopts= -m gpu

(``--noconftest``: the suite's conftest configures JAX).  Tolerances,
float32 on both sides, normwise (max |a - b| / max(1, max |b|)): K1 1e-4
(bfloat16 H: 1e-2, one rounding of the stored H), K2 values 1e-5 and
gradients 1e-4, K3 1e-5 with rows that have no valid key exactly zero (its
QK^T on the tensor cores as three TF32 products, float32 accuracy), K1′
as K1, K4 values 1e-5 and directional derivatives 1e-4 (K2 and K4 also at
scene sizes other than (4, 8), through their general kernels).
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
    actual, expected = actual.double().cpu(), expected.double().cpu()
    return float((actual - expected).abs().max() / max(1.0, float(expected.abs().max())))


def _k1_inputs(b, p, seed=0, asymmetry=0.0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(b, p, p, generator=g) / p**0.5
    h = torch.eye(p) + a @ a.transpose(1, 2)
    if asymmetry:  # a normal matrix that is not symmetric, from its own generator
        h = h + asymmetry * torch.randn(b, p, p, generator=torch.Generator().manual_seed(seed + 1))
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
def test_bfgs_update_kernel_at_the_bootstrap_batch(cuda_device):
    """vo-eval's bootstrap solve: one window x 8 restarts, B = 8 (one
    partial tile of the register route)."""
    h_t, s, y, grad, updating = _k1_inputs(8, 45)
    on_card = [x.to(cuda_device) for x in (h_t, s, y, grad, updating)]
    for first, second in FLAGS:
        before = build.launch_counts["bfgs_update"]
        k_h, k_d = k1.fused_bfgs_update_direction(*on_card, first, second)
        torch.cuda.synchronize()
        assert build.launch_counts["bfgs_update"] == before + 1
        p_h, p_d = k1.fused_bfgs_update_direction(h_t, s, y, grad, updating, first, second)
        assert _normwise(k_h, p_h) <= 1e-4
        assert _normwise(k_d, p_d) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(1, 15), (56, 45)], ids=["scale_drift_p15_b1", "stacked_windows_p45_b56"])
def test_bfgs_update_kernel_at_the_windows_shapes(cuda_device, b, p):
    """The windows pipeline's shapes: correct_scale_drift's BFGS over the
    15 segments of 16 frames (B = 1), and the 7 stacked windows x 8
    restarts of a 16-frame sequence (B = 56)."""
    h_t, s, y, grad, updating = _k1_inputs(b, p, seed=b)
    on_card = [x.to(cuda_device) for x in (h_t, s, y, grad, updating)]
    for first, second in FLAGS:
        before = build.launch_counts["bfgs_update"]
        k_h, k_d = k1.fused_bfgs_update_direction(*on_card, first, second)
        torch.cuda.synchronize()
        assert build.launch_counts["bfgs_update"] == before + 1
        p_h, p_d = k1.fused_bfgs_update_direction(h_t, s, y, grad, updating, first, second)
        assert _normwise(k_h, p_h) <= 1e-4
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


@pytest.mark.gpu
@pytest.mark.parametrize("ordering", [k1v.rowloop_update_direction, k1v.rowloop2_update_direction])
@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("elements_per_block", k1v.ELEMENTS_PER_BLOCK)
@pytest.mark.parametrize("offset", [0, 1])  # 1: a bfloat16 carry at an odd element, no packed pairs
def test_bfgs_update_variant_kernel_on_a_nonsymmetric_carry(cuda_device, ordering, h_dtype, elements_per_block, offset):
    """H + 0.05 N, N not symmetric: K1′ reduces yᵀH over the rows, as its
    plain versions and the TPU kernels do.  A kernel that took yᵀH from Hy
    (K1's shortcut by symmetry) fails here on every step but the first:
    its d is off by about 5e-2 normwise against the 1e-4 tolerance."""
    h_t, s, y, grad, updating = _k1_inputs(1000, 45, seed=3, asymmetry=0.05)  # a ragged last block
    h_t = h_t.to(h_dtype)
    buf = torch.empty(h_t.numel() + offset, dtype=h_dtype, device=cuda_device)
    h_card = buf[offset:].view(h_t.shape)
    h_card.copy_(h_t)
    on_card = [x.to(cuda_device) for x in (s, y, grad, updating)]
    for first, second in FLAGS:
        k_h, k_d = ordering(h_card, *on_card, first, second, elements_per_block=elements_per_block)
        torch.cuda.synchronize()
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
# whole blocks of 8 elements; a ragged last one; one block; vo-eval's bootstrap solve (8)
@pytest.mark.parametrize("b", [1000, 1003, 5, 8])
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
@pytest.mark.parametrize("m,n", [(4, 32), (3, 8), (4, 12), (6, 16)])
def test_calibration_kernels_at_other_scene_sizes(cuda_device, m, n):
    """K2 and K4's general kernels (every size but (4, 8)): eval-seq's
    default (4, 32), 3 views, N not a power of two, 96 terms; a ragged
    last block."""
    params, u, v, vis, direction = _objective_inputs(1003, m, n)
    before = dict(build.launch_counts)
    k_err, k_grad = k2.calibration_value_and_grad(*(x.to(cuda_device) for x in (params, u, v, vis)))
    d_err, d_dphi = k2.calibration_value_and_dirderiv(*(x.to(cuda_device) for x in (params, direction, u, v, vis)))
    torch.cuda.synchronize()
    for name in ("calibration_value_and_grad", "calibration_value_and_dirderiv"):
        assert build.launch_counts[name] == before[name] + 1
    p_err, p_grad = k2.calibration_value_and_grad(params, u, v, vis)
    _, p_dphi = k2.calibration_value_and_dirderiv(params, direction, u, v, vis)
    assert _normwise(k_err, p_err) <= 1e-5 and _normwise(d_err, p_err) <= 1e-5
    assert _normwise(k_grad, p_grad) <= 1e-4
    assert _normwise(d_dphi, p_dphi) <= 1e-4
    assert float(k_err[7]) == 0.0 and float(d_dphi[7]) == 0.0  # nothing visible


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    h_t, s, y, grad, updating = (x.to(cuda_device) for x in _k1_inputs(64, 7))
    with pytest.raises(ValueError):  # float64 H
        k1.fused_bfgs_update_direction(h_t.double(), s, y, grad, updating, False, False)
    with pytest.raises(ValueError):  # 8 elements per block is not compiled
        k1v.rowloop2_update_direction(h_t, s, y, grad, updating, False, False, elements_per_block=8)
    x = torch.zeros(64, 144, device=cuda_device)  # (M, N) = (16, 17): 272 terms, above the cap of 256
    obs = torch.zeros(16, 17, 64, device=cuda_device)
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
        (15, 144, 144, 64, 2),  # vo-eval: the whole sequence's 15 anchor-to-view problems
        (3, 144, 144, 64, 2),  # vo-eval: a bootstrap window's 3
        (4, 8, 144, 64, 2),  # sequential tracking: 8 track queries against a frame's 144 cells
        (4, 32, 144, 64, 2),
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


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One training step of the MLP head (hidden 32) through a 3-iteration
    unrolled solve with drop-path 0.1 (keep-masks drawn once on the CPU),
    float64, batch 16, on the card and on the CPU from the same weights and
    batch: loss, metrics, updated parameters and running statistics to
    1e-8 normwise, and no kernel launched (the training solve is unfused)."""
    import dataclasses

    from davo_tpu_torch.data import SceneConfig, generate_batch
    from davo_tpu_torch.solve import BFGSConfig
    from davo_tpu_torch.train import CalibrationExperiment, create_train_state, make_train_step
    from davo_tpu_torch.types import CameraViewsAndPoints

    batch = generate_batch(torch.Generator().manual_seed(5), 16, SceneConfig(dtype=torch.float64), device="cpu")
    keep_masks = torch.rand(3, 16, generator=torch.Generator().manual_seed(6)) > 0.1

    @dataclasses.dataclass(frozen=True)
    class FixedBatch(CalibrationExperiment):
        def make_batch_fn(self, device=None):
            moved = CameraViewsAndPoints(*(x.to(device) for x in batch))
            return lambda generator, batch_size: moved

    config = FixedBatch(
        hidden_size=32, batch_size=16, dtype=torch.float64,
        solver=BFGSConfig(error_threshold=1e-7, training_error_threshold=1e-3, iterations=100, training_iterations=3,
                          line_search_iterations=50, drop_path_p=0.1),
    )
    results = []
    for device in (cuda_device, torch.device("cpu")):
        state = create_train_state(config, device)
        build.reset_launch_counts()
        metrics = make_train_step(state, config)(torch.Generator(device).manual_seed(0), keep_masks=keep_masks)
        assert not any(build.launch_counts.values())
        results.append((metrics, state.network.state_dict()))
    (metrics, weights), (cpu_metrics, cpu_weights) = results
    for name, value in cpu_metrics.items():
        assert _normwise(metrics[name], value) <= 1e-8, name
    for name, value in cpu_weights.items():
        if not name.endswith("num_batches_tracked"):
            assert _normwise(weights[name], value) <= 1e-8, name


@pytest.mark.gpu
def test_lbfgs_eval_on_the_card_launches_k2_and_matches_the_cpu(cuda_device):
    """The L-BFGS eval solve (history 5, 10 iterations) of 256 problems
    through the fused objective, float32: on the card it launches K2 once an
    iteration and never K1 (no dense H); the solved estimates of at least
    90 % of the problems agree with the CPU solve (plain K2) to 1e-3
    normwise (a Wolfe decision that rounding flips sends an element down
    another path), and both lower every problem's error."""
    from davo_tpu_torch.data import SceneConfig, generate_batch
    from davo_tpu_torch.solve import LBFGSConfig, lbfgs_solve

    scenes = generate_batch(torch.Generator().manual_seed(3), 256, SceneConfig(), device="cpu")
    g = torch.Generator().manual_seed(4)
    guess = 0.1 * torch.randn(256, 45, generator=g)
    guess[:, 0] += 1.0
    guess[:, 5:27:3] += 1.0
    config = LBFGSConfig(history=5, error_threshold=1e-7, iterations=10, line_search_iterations=50)
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        error_fn, value_and_grad = k2.make_fused_calibration_objective(
            scenes.projected_points.to(device), scenes.visibility_mask.to(device)
        )
        build.reset_launch_counts()
        solved = lbfgs_solve(error_fn, guess.to(device), config, value_and_grad_fn=value_and_grad)
        launches = dict(build.launch_counts)
        start, end = error_fn(guess.to(device)), error_fn(solved)
        assert bool(torch.all(end <= start)), device
        out[device.type] = (solved.cpu(), launches)
    launches = out["cuda"][1]
    assert launches["calibration_value_and_grad"] > 0 and launches["bfgs_update"] == 0
    assert not any(out["cpu"][1].values())
    diff = (out["cuda"][0] - out["cpu"][0]).abs().amax(dim=1) / out["cpu"][0].abs().amax(dim=1).clamp(min=1.0)
    assert float((diff <= 1e-3).float().mean()) >= 0.9


@pytest.mark.gpu
def test_frontend_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Two front-end train steps at 32 px (descriptor and embedding 8, batch
    2, dropout 0.1 with injected masks, a one-step warm-up, so that the
    second update's rate is the peak), float64, on the card and on the CPU
    from the same flax-style weights, windows and render noise: each
    step's metrics, the parameters, their change over the two steps,
    AdamW's two moments and the BatchNorm statistics to 1e-8 (each kind
    normwise over the network, in the 2-norm: the key projection's bias
    has a gradient of 0 but for rounding, which AdamW turns into updates
    of lr * noise / eps on either side), and no kernel launched (the
    training matcher is the plain softmax)."""
    from davo_tpu_torch.data import RenderConfig, VOWindowConfig, generate_vo_window_batch
    from davo_tpu_torch.train import FrontendExperiment, create_frontend_state, draw_render_noise
    from davo_tpu_torch.train import make_frontend_train_step

    config = FrontendExperiment(
        descriptor_channels=8, embedding_size=8, batch_size=2, warmup_steps=1,
        window=VOWindowConfig(dtype=torch.float64), render=RenderConfig(image_size=32, dtype=torch.float64),
    )
    g = torch.Generator().manual_seed(7)
    draws = [(generate_vo_window_batch(g, 2, config.window, device="cpu"),
              draw_render_noise(g, 2, 4, 8, config.render, torch.device("cpu")),
              torch.rand(2 * 3, 16, 16, generator=g) < 0.9) for _ in range(2)]
    results = []
    for device in (cuda_device, torch.device("cpu")):
        state = create_frontend_state(config, device, dropout=0.1)
        initial = {k: p.detach().clone() for k, p in state.network.named_parameters()}
        train_step, _ = make_frontend_train_step(state, config)
        build.reset_launch_counts()
        metrics = [train_step(
            windows=type(windows)(*(x.to(device) for x in windows)),
            noise={k: {n: x.to(device) for n, x in v.items()} for k, v in noise.items()},
            dropout_mask=mask.to(device),
        ) for windows, noise, mask in draws]
        assert not any(build.launch_counts.values())
        tensors = {("statistic" if "running_" in k else "parameter", k): v
                   for k, v in state.network.state_dict().items() if not k.endswith("num_batches_tracked")}
        for k, p in state.network.named_parameters():
            tensors["update", k] = p.detach() - initial[k]
            tensors["first moment", k] = state.optimizer.state[p]["exp_avg"]
            tensors["second moment", k] = state.optimizer.state[p]["exp_avg_sq"]
        results.append((metrics, tensors))
    (metrics, tensors), (cpu_metrics, cpu_tensors) = results

    assert float(cpu_tensors["update", "matcher.query.weight"].abs().max()) > 0
    for step, cpu_step in zip(metrics, cpu_metrics):
        for name, value in cpu_step.items():
            assert abs(float(step[name]) - float(value)) <= 1e-8 * abs(float(value)), name
    squares = {}
    for (kind, name), value in cpu_tensors.items():
        err, ref = squares.get(kind, (0.0, 0.0))
        diff = tensors[kind, name].double().cpu() - value.double().cpu()
        squares[kind] = (err + float(torch.sum(diff * diff)), ref + float(torch.sum(value.double() ** 2)))
    for kind, (err, ref) in squares.items():
        assert err <= (1e-8) ** 2 * ref, kind


@pytest.mark.gpu
def test_incremental_vo_accumulator_on_the_card_matches_the_cpu(cuda_device):
    """solve_incremental_vo_detections on chip_smoke.py's clean inputs (10
    frames of 8 points among junk detections, a truth bootstrap, ba_irls 1,
    pnp_ransac 4, chain_passes 2, reject_outliers): the card in float32
    against the CPU in float64, rotations to 1e-4 and translations to 1e-3,
    the card's ATE below 5e-3, no kernel launched."""
    import chip_smoke

    result = chip_smoke.vo_clean_accumulator(cuda_device)
    assert result["rotation_max_abs_err"] <= 1e-4 and result["translation_max_abs_err"] <= 1e-3
    assert result["ate_rmse_card"] < 5e-3


@pytest.mark.gpu
def test_windows_pipeline_recovers_oracle_windows_on_the_card(cuda_device):
    """The windows pipeline on oracle guesses (each window's truth at its
    own gauge scale, one stacked call), stitched (chain and global) and
    refined on the card in float32: the refined ATE within 1e-4, the JAX
    test's bound (chip_smoke.vo_windows_recovery)."""
    import chip_smoke

    result = chip_smoke.vo_windows_recovery(cuda_device)
    assert result["chain"]["refined_ate"] <= 1e-4 and result["global"]["refined_ate"] <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("b,p", [(256, 45), (64, 44)], ids=["learned_solver_p45_b256", "gen1_p44_b64"])
def test_bfgs_update_kernel_at_the_learned_solver_and_gen1_shapes(cuda_device, b, p):
    """compare_with_bfgs's BFGS solves (256 scenes, P = 45) and the gen-1
    protocol solve of 64 scenes (P = 3 + 6 M + 3 N - 7 = 44)."""
    h_t, s, y, grad, updating = _k1_inputs(b, p, seed=b + p)
    on_card = [x.to(cuda_device) for x in (h_t, s, y, grad, updating)]
    for first, second in FLAGS:
        before = build.launch_counts["bfgs_update"]
        k_h, k_d = k1.fused_bfgs_update_direction(*on_card, first, second)
        torch.cuda.synchronize()
        assert build.launch_counts["bfgs_update"] == before + 1
        p_h, p_d = k1.fused_bfgs_update_direction(h_t, s, y, grad, updating, first, second)
        assert _normwise(k_h, p_h) <= 1e-4
        assert _normwise(k_d, p_d) <= 1e-4


@pytest.mark.gpu
def test_compare_with_bfgs_on_the_card_matches_the_cpu(cuda_device):
    """One compare_with_bfgs batch of 256 scenes (the trained MLP solver of
    artifacts/learned_solver_descent_v2.pkl, float32), drawn on the CPU and
    solved on each device: the starts' row equal to 1e-6, the BFGS rows'
    objectives to 2 % and basin rates to 0.03 (a Wolfe decision that
    rounding flips sends an element down another path), the learned row's
    objective to 5 % (the trained solver diverges on such starts, which
    amplifies rounding a step); K1 launched on the card, nothing on the
    CPU."""
    from pathlib import Path

    from davo_tpu_torch.data import generate_batch
    from davo_tpu_torch.train import compare_with_bfgs, load_learned_solver, make_problem
    from davo_tpu_torch.types import CameraViewsAndPoints

    path = Path(__file__).resolve().parents[1] / "artifacts" / "learned_solver_descent_v2.pkl"
    tables, launches = {}, {}
    for device in (cuda_device, torch.device("cpu")):
        network, config = load_learned_solver(path, device=device)
        g = torch.Generator().manual_seed(7)
        batch = generate_batch(g, config.batch_size, config.resolved_scene(), device="cpu")
        noise = torch.randn(config.batch_size, config.num_parameters, generator=g)
        problem = make_problem(config, CameraViewsAndPoints(*(x.to(device) for x in batch)), noise.to(device))
        build.reset_launch_counts()
        tables[device.type] = compare_with_bfgs(network, config, 0, device=device, problems=[problem])
        launches[device.type] = dict(build.launch_counts)
    assert launches["cuda"]["bfgs_update"] > 0 and not any(launches["cpu"].values())
    card, cpu = tables["cuda"], tables["cpu"]
    assert card["start"]["objective"] == pytest.approx(cpu["start"]["objective"], rel=1e-6)
    for row in ("bfgs_equal_budget", "bfgs_4x_budget"):
        assert card[row]["objective"] == pytest.approx(cpu[row]["objective"], rel=2e-2), row
        assert abs(card[row]["basin_rate"] - cpu[row]["basin_rate"]) <= 0.03, row
    assert card["learned"]["objective"] == pytest.approx(cpu["learned"]["objective"], rel=5e-2)


@pytest.mark.gpu
def test_gen1_protocol_solve_on_the_card_launches_k1_and_matches_the_cpu(cuda_device):
    """bfgs_solve_function on 64 PinholeCameraModelL1 objectives (4 views x
    8 points, P = 44, float32; chip_smoke.gen1_protocol_solve), built on
    the CPU and solved on each device: K1 launched on the card and never
    on the CPU; at least 90 % of the solved parameter vectors agree to
    1e-3 normwise; on both, the mean objective falls and at least 90 % of
    the objectives fall (the constrained step's clamps can defeat a line
    search, as in the JAX package: on the CPU one of the 64 rises)."""
    import chip_smoke

    result = chip_smoke.gen1_protocol_solve(cuda_device)
    assert result["launches"]["bfgs_update"] > 0 and not any(result["cpu"]["launches"].values())
    assert result["share_agreeing_1e3"] >= 0.9
    for side in ("card", "cpu"):
        assert result[side]["mean_objective_solved"] < result[side]["mean_objective_start"], side
        assert result[side]["share_lowered"] >= 0.9, side


@pytest.mark.gpu
def test_distorted_refinement_on_the_card_matches_the_cpu(cuda_device):
    """refine_distorted on 16 scenes in float64, the card against the CPU
    to 1e-9 (chip_smoke.distorted_card_against_cpu), with TF32 off; and
    cli eval-distorted on the card at a small size, finite and within the
    JAX float32 test's bound."""
    import chip_smoke
    from davo_tpu_torch import cli

    result = chip_smoke.distorted_card_against_cpu(cuda_device)
    assert result["max_abs_err"] <= 1e-9 and result["max_param_error_card"] < 1e-6
    assert not torch.backends.cuda.matmul.allow_tf32
    printed = cli.run(["eval-distorted", "--batches", "2", "--batch-size", "8"])
    assert all(np.isfinite(v) for v in printed.values()) and printed["worst_max_param_error"] < 5e-3


@pytest.mark.gpu
def test_track_sequence_on_the_card_launches_k3_once_a_frame(cuda_device):
    """Sequential tracking of chip_smoke's orbits (4 sequences of 16 frames
    at 96 px, frontend_v4 with vo_eval's gates): K3 once a frame after the
    first, at 8 track queries against 144 cells; finite matches."""
    import chip_smoke

    frontend, images, _, _ = chip_smoke.track_inputs(cuda_device)
    build.reset_launch_counts()
    out = frontend(images, track_sequence=True)
    torch.cuda.synchronize()
    assert build.launch_counts["match_attention"] == images.shape[1] - 1
    assert out.matches.shape == (images.shape[0], images.shape[1], 8, 2) and bool(torch.isfinite(out.matches).all())


@pytest.mark.gpu
def test_save_checkpoint_takes_cuda_tensors(tmp_path, cuda_device):
    """The Orbax writer on tensors on the card (float32, float64, a 0-d
    int64 step): moved to the host and read back bit for bit."""
    from davo_tpu_torch.train import restore_checkpoint, save_checkpoint

    tree = {"params": {"w": torch.randn(64, 33, device=cuda_device),
                       "h": torch.ones(3, device=cuda_device, dtype=torch.float64)},
            "step": torch.tensor(5, device=cuda_device)}
    path = save_checkpoint(str(tmp_path), 5, tree)
    assert path == str(tmp_path / "checkpoint_5")
    back = restore_checkpoint(str(tmp_path))
    assert back["params"]["w"].tobytes() == tree["params"]["w"].cpu().numpy().tobytes()
    assert back["params"]["h"].dtype == np.float64 and back["step"].dtype == np.int64 and int(back["step"]) == 5
