"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its seconds:

1. device   the card's name, count and power limit (nvidia-smi);
2. build    nvcc builds the port's CUDA kernels (ptxas's register, stack
            and spill lines);
3. k1, k2   each kernel against its plain PyTorch version on the card, at the
            serve shape (B = 8192, also 32 restarts of 256 scenes), the bench
            shape (B = 16384) and the trainer's validation batch (B = 64): error
            against the stated tolerance, time by CUDA events (``ms``: the
            wrapper's launches one by one from the host, as the solver makes
            them; ``graph_ms``: the same launches replayed from a CUDA graph,
            the card's time without the host's), the least time the card
            could take (bound), the share of it reached (by ``ms``), and the
            timed kernel's registers and spill bytes from ptxas;
   k3       the attention kernel against its plain version at the matcher's
            shape (3,072 problems of 144 x 144, D = 64, C = 2) and on masked,
            ragged inputs; its time beside the plain version's and beside
            torch's scaled_dot_product_attention as the matcher would call
            it (timed only as a yardstick); its bound on the tensor cores
            and, apart, on the CUDA cores alone;
   k4       the value + directional derivative kernel against its plain
            version at B = 16384 and 8192, with an element that sees nothing
            and elements with f <= 0, as k2;
   k1v      the K1' orderings (rowloop, rowloop2; 16 elements per block)
            against their plain versions at B = 16384, as k1, on a
            symmetric carry and on one that is not (K1' reduces y'H over
            the rows; K1 takes it from Hy by symmetry);
4. serve    the v2_600 calibration network (transformer head, embed 256,
            6 layers, 8 heads) loaded from the JAX package's numpy checkpoint,
            answering 2 requests of 1,024 generated scenes with 8 restarts
            each (8,192-element BFGS solves, strong Wolfe search); latency,
            errors against ground truth, and the kernels' launch counts;
            plus the same network on a small input against the CPU run,
            and a torch.profiler breakdown of one request (5 iterations);
5. frontend_serve  learned-match window calibration: 2 requests of 1,024 VO
            windows generated and rendered at 96 px on the card, the front end
            (frontend_v4 weights, every gate off as it was validated: U-Net
            detector, top-k anchors, attention matcher through K3) and the
            window solver (vo_windows_transformer_v2_600, 8 restarts) on its
            matches; latency split, match_inlier_rate, errors, launch counts;
            request 0's solve watching K1's carry (its drift from symmetry,
            and, once the counts are read, what K1's y'H = (Hy)' changes
            on it); then, outside the counted run, request 0's first 256
            windows solved on vo-eval's default front end (greedy NMS
            anchors) and on oracle matches; plus 8 windows through the
            front end and a 5-iteration solve on the card against the CPU
            run;
6. bench    one BFGS solve at bench.py's shape (B = 16384, 4 views x 8
            points, 20 iterations, backtracking capped at 6 probes);
7. fused_objective  the entry points davo_tpu_torch.scripts.check_fused_objective
            (K2 and K4 against torch autodiff of the plain objective) and
            .time_fused_objective (K2, K4 and torch's value+grad and
            value+dirderiv, slope-timed), their lines passed through;
8. k1_tune  the entry point davo_tpu_torch.scripts.tune_bfgs_kernel: nine
            cases of K1 and K1' (orderings, blocks, H type), each checked
            against its plain version, then slope-timed;
9. eval_v4  the eval entry (python -m davo_tpu_torch.cli eval) at the JAX
            package's v4_1800 checkpoint (transformer head, embed 448, 10
            layers, 8 heads), 8 restarts, one eval batch and four ATE
            batches of 64 scenes (eval_lbfgs's); its JSON, the seconds per
            solve and the comparison with artifacts/eval_v4_calib.log;
10. eval_restarts  the eval proposals and selections on 256 scenes a case, one
            solve each through the library's evaluate_calibration_ate: v4_1800
            with 32 noise restarts and basin selection, with 8 permutation and
            with 8 input-noise restarts (error selection), and the
            v5_tokens8 weights (8 readout tokens, architecture read from the
            pickle) with its tokens as the 8 starts; ATE and f_error beside the
            JAX package's logs, seconds per solve, launches;
11. train_check  one train step (MLP head, 3-iteration unrolled solve,
            drop-path with injected keep-masks, float64) on the card against
            the CPU: loss, metrics, updated parameters and running statistics;
12. train   each calibration recipe at full width: 20 train steps and 1
            validation batch (the reference recipe's MLP head through its
            10-iteration unrolled solve, from a flax-style init; the curriculum
            transformer at v4_1800's width from its weights): losses, seconds
            per step, peak device memory, K1/K2 launches (none in the train
            steps, whose solve is unfused as in the JAX package) and a
            checkpoint round trip through fit (1 + 1 against 2 epochs); the
            reference recipe's step also under a torch.profiler window of 5
            more steps after its validation (its device busy share);
13. eval_lbfgs  the eval entry with --solver lbfgs at v4_1800 (8 restarts, one
            eval batch and four ATE batches of 64 scenes): K2 launched through
            the solver's value+gradient hook, K1 never (L-BFGS has no dense
            H); ATE and f_error beside artifacts/eval_v4_lbfgs.log, seconds per
            solve;
14. frontend_train_check  two front-end train steps (32 px, width 8, dropout
            0.1 with injected masks, a one-step warm-up, float64) on the
            card against the CPU: metrics, updated parameters, both AdamW
            moments and BatchNorm statistics;
15. frontend_train  fit_frontend at the frontend_v4 recipe's full width (batch
            16, 64 steps and 8 validation batches an epoch, 96 px) from a
            flax-style init for 12 epochs beside
            artifacts/frontend_v4_metrics.jsonl: per-epoch losses and
            match_inlier_rate, K3 launches (0 in the train steps, > 0 in each
            validation), peak memory; then each step timed alone, a profiler
            window of 5 steps, and the checkpoint round trip (saved as
            fit-frontend saves it, read back by load_frontend);
16. the kernels line (with each kernel's launches on every path that ran
   it), then the last line:
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any mismatch beyond tolerance, a failed build or launch, or a kernel a
path never launched raises, and the script exits non-zero.  Without a
card it exits non-zero before doing anything.  Each path's launch counts
are set to 0 just before it and read just after: K1, K2 and K3 from the
learned-match window path, K4 from the fused-objective entry points, K1'
from the tuning sweep, K2 from the L-BFGS eval, K3 from the front end's
validation (its train steps read 0).
"""

import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(REPO, "artifacts", "calibration_transformer_v2_600.pkl")
WINDOW_CHECKPOINT = os.path.join(REPO, "artifacts", "vo_windows_transformer_v2_600.pkl")
V4_CHECKPOINT = os.path.join(REPO, "artifacts", "calibration_transformer_v4_1800.pkl")
V4_REFERENCE_LOG = os.path.join(REPO, "artifacts", "eval_v4_calib.log")

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_TF32_OPS_PER_S = 495e12  # tensor cores, dense

# 2 serve requests: with the eval entry's five solves in the run, every
# path fits in about half the time limit
SERVE_SCENES, SERVE_RESTARTS, SERVE_REQUESTS = 1024, 8, 2
BENCH_BATCH, BENCH_ITERATIONS, BENCH_PROBES = 16384, 20, 6
# the trainer's validation batch (K1 and K2 at 8,192 elements, 32
# restarts of 256 scenes, are the serve shape's)
VAL_BATCH = 64
M, N = 4, 8
WINDOWS, WINDOW_REQUESTS, COMPARISON_WINDOWS = 1024, 2, 256
# vo-eval's default front end (davo_tpu/cli.py: --nms-radius 0.1, every
# other gate 0); the main path runs the front end as it was validated, top-k
VO_EVAL_GATES = dict(nms_radius=0.1)
# the matcher's attention at the served shape: the anchor's 12 x 12 cells
# against each of the M - 1 other views' (96 px images, 64-wide embedding)
K3_PROBLEMS, K3_CELLS, K3_DEPTH, K3_WIDTH = (M - 1) * WINDOWS, 144, 64, 2
# the eval entry at v4_1800: the architecture read from the pickle (embed
# 448, 10 layers, 8 heads of 56); one eval batch and the four ATE batches
# of 64 scenes (five solves of 512 elements), as the JAX log's ATE (4 x 64)
# and on eval_lbfgs's scenes; batches of 1,024 scenes took 155-227 s, which
# the run's time limit cannot spare
EVAL_V4_ARGS = [
    "eval", "--preset", "calibration_transformer_curriculum", "--hidden-size", "448",
    "--transformer-layers", "10", "--transformer-heads", "8", "--restarts", "8",
    "--batch-size", "64", "--batches", "1",
]
EVAL_V4_SOLVES = 1 + 4
# acceptance bands around the JAX package's figures (eval_v4_calib.log:
# 256 scenes from other random draws)
EVAL_V4_BANDS = {"ate_rmse_mean": (0.19, 0.28), "f_error_mean": (0.12, 0.20)}
# the eval proposals and selections: 256 scenes a case, each beside the
# JAX package's log (256 scenes from jax.random draws) within a wide band
V5_CHECKPOINT = os.path.join(REPO, "artifacts", "calibration_transformer_v5_tokens8.pkl")
EVAL_RESTART_SCENES = 256
EVAL_RESTART_CASES = [
    ("v4_1800 noise x32 basin", V4_CHECKPOINT, dict(num_restarts=32, restart_proposals="noise", selection="basin"),
     ("eval_v4_calib_r32basin.log", None)),
    ("v4_1800 permutation x8 error", V4_CHECKPOINT,
     dict(num_restarts=8, restart_proposals="permutation", selection="error"), ("eval_v4_perm8.log", None)),
    ("v4_1800 input_noise x8 error", V4_CHECKPOINT,
     dict(num_restarts=8, restart_proposals="input_noise", selection="error"),
     ("recipe_evals_r4.log", "v4 + input_noise @8 error")),
    ("v5_tokens8 tokens x8 error", V5_CHECKPOINT, dict(num_restarts=8, restart_proposals="tokens", selection="error"),
     ("recipe_evals_r5.log", "v5t_tokens8_error")),
]
EVAL_RESTART_BAND = (0.6, 1.5)  # times the JAX figure
# training: one step on the card against the CPU (float64), then each
# recipe's steps, validation and a checkpoint round trip
TRAIN_CHECK_TOL = 1e-8
# one validation batch a recipe: each costs 11-13 s, and with two the run
# passed 900 s of its limit on a slow host
TRAIN_STEPS, TRAIN_VAL_BATCHES = 20, 1
RESUME_EVAL_ITERATIONS, RESUME_TOL = 10, 1e-6
# a torch.profiler window over this many train steps gives a step's
# device busy share; the serve profile's solve runs PROFILED_ITERATIONS
# (the profiler's post-processing of a 10-iteration solve takes about 45 s)
PROFILED_STEPS, PROFILED_ITERATIONS = 5, 5
# the eval entry with L-BFGS at v4_1800: 8 restarts, one eval batch and the
# four ATE batches of 64 scenes (256 scenes, as eval_v4_lbfgs.log's)
EVAL_LBFGS_ARGS = [
    "eval", "--preset", "calibration_transformer_curriculum", "--hidden-size", "448",
    "--transformer-layers", "10", "--transformer-heads", "8", "--restarts", "8",
    "--batch-size", "64", "--batches", "1", "--solver", "lbfgs",
]
EVAL_LBFGS_SOLVES = 1 + 4
# the front end's training: two steps on the card against the CPU (float64,
# a small size), then the frontend_v4 recipe at full width (4 views x 8
# points, select 8, descriptor and embedding 64, batch 16, 64 batches and 8
# validation batches an epoch, 96 px, learning rate 3e-4, warm-up 200) for
# FRONTEND_EPOCHS epochs beside artifacts/frontend_v4_metrics.jsonl
FRONTEND_TRAIN_CHECK_TOL = 1e-8
FRONTEND_EPOCHS, FRONTEND_IMAGE_SIZE = 12, 96
FRONTEND_TIMED_STEPS = 20
FRONTEND_LOSS_BAND, FRONTEND_INLIER_FLOOR = (0.6, 1.5), 0.5  # times the JAX log's figure at the same epoch
FRONTEND_REFERENCE_LOG = os.path.join(REPO, "artifacts", "frontend_v4_metrics.jsonl")
# the paths whose launch counts the kernels line reports
LAUNCH_PATHS = ("frontend_serve", "fused_objective", "k1_tune", "eval_v4", "eval_lbfgs", "frontend_train")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps, warmup=3):
    """Mean milliseconds per call of ``fn`` by CUDA events over ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_replay_ms(fn, reps, rounds=5):
    """Mean milliseconds per call of ``fn`` replayed from a CUDA graph of
    ``reps`` calls (``rounds`` replays, by CUDA events): the card's time
    for the launches, without the host's time to enqueue each one."""
    fn()  # warm-up, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * rounds)


def ptxas_resources(lines, symbol):
    """Registers and stack/spill bytes of each compiled kernel whose
    mangled name holds ``symbol``, from ptxas's -v lines."""
    found, current = [], None
    for line in lines:
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = dict(function=entry.group(1)) if symbol in entry.group(1) else None
            if current is not None:
                found.append(current)
        elif current is not None:
            used = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if used:
                current["registers"] = int(used.group(1))
            if spill:
                current.update(stack_bytes=int(spill.group(1)), spill_store_bytes=int(spill.group(2)),
                               spill_load_bytes=int(spill.group(3)))
    return found


def check(name, actual, expected, tol):
    """Normwise relative error ``max|a - e| / max(1, max|e|)`` within tol,
    taken in float64 (float32 rounding would hide a float64 check's
    differences)."""
    diff = (actual.double() - expected.double()).abs().max().item()
    scale = max(1.0, expected.double().abs().max().item())
    rel = diff / scale
    if not math.isfinite(rel) or rel > tol:
        raise AssertionError(f"{name}: max abs diff {diff} (normwise {rel}) exceeds {tol}")
    return {"max_abs_err": diff, "normwise_rel_err": rel, "tolerance": tol}


def relative_error(actual, expected):
    """``|a - e| / |e|`` of two scalars, in float64."""
    expected = float(expected)
    return abs(float(actual) - expected) / (abs(expected) or 1.0)


def bound(bytes_moved, operations):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = operations / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- K1 ----


def k1_inputs(batch, p, h_dtype, device, seed, asymmetry=0.0):
    """Symmetric positive-definite H (plus ``asymmetry`` times a normal
    matrix that is not symmetric, from its own generator), curvature pairs
    y = A s with A SPD (y.s > 0), 1/16 of the elements with y.s <= 0, a
    mixed updating mask."""
    g = torch.Generator(device).manual_seed(seed)
    a = torch.randn(batch, p, p, generator=g, device=device) / math.sqrt(p)
    h = torch.eye(p, device=device) + a @ a.transpose(1, 2)
    if asymmetry:
        h += asymmetry * torch.randn(batch, p, p, generator=torch.Generator(device).manual_seed(seed + 1), device=device)
    s = 0.1 * torch.randn(batch, p, generator=g, device=device)
    b = torch.randn(batch, p, p, generator=g, device=device) / math.sqrt(p)
    y = torch.einsum("bij,bj->bi", torch.eye(p, device=device) + b @ b.transpose(1, 2), s)
    k = batch // 16
    y[:k] = -s[:k] * torch.rand(k, p, generator=g, device=device)
    grad = torch.randn(batch, p, generator=g, device=device)
    updating = torch.rand(batch, generator=g, device=device) > 0.25
    h_t = h.permute(1, 2, 0).contiguous().to(h_dtype)
    return h_t, s.contiguous(), y.contiguous(), grad.contiguous(), updating


def k1_symbol(h_dtype, variant_symbol=None):
    """The mangled-name fragment of the kernel a K1 phase times at P = 45
    and an even batch: K1's register route (one float32 element or a
    bfloat16 pair a thread), or K1''s kernel in the ordering
    ``variant_symbol`` (16 elements a block: one element a thread)."""
    type_code = "13__nv_bfloat16" if h_dtype == torch.bfloat16 else "f"
    if variant_symbol:
        return f"{variant_symbol}{type_code}Li1E"
    return f"bfgs_update_rows_kernelI{type_code}Li{2 if h_dtype == torch.bfloat16 else 1}E"


def k1_phase(batch, h_dtype, device, variant=None):
    """K1, or with ``variant = (kernel, plain, symbol)`` one of the K1'
    orderings, against its plain version and timed.  K1 is checked on a
    symmetric carry (it takes y'H = (Hy)' by symmetry); K1' on that carry
    and on one that is not symmetric (H + 0.05 N), since it reduces y'H
    over the rows as the TPU kernels do."""
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.ops.bfgs_update import fused_bfgs_update_direction, reference_update_direction

    kernel, plain_version, symbol = variant or (fused_bfgs_update_direction, reference_update_direction, None)
    p = 3 + 3 * N + 6 * (M - 1)
    h_tol = 1e-2 if h_dtype == torch.bfloat16 else 1e-4  # bf16: one rounding of H+
    checks, worst = {}, 0.0
    for asymmetry in ((0.0, 0.05) if variant else (0.0,)):
        h_t, s, y, grad, updating = k1_inputs(batch, p, h_dtype, device, seed=batch, asymmetry=asymmetry)
        h_bm = h_t.permute(2, 0, 1).float()
        carry = "nonsymmetric_" if asymmetry else ""
        for label, first, second in (("step1", True, False), ("step2", False, True), ("later", False, False)):
            k_h, k_d = kernel(h_t, s, y, grad, updating, first, second)
            torch.cuda.synchronize()
            p_h, p_d = plain_version(h_bm, s, y, grad, updating, first, second)
            p_h = p_h.permute(1, 2, 0).to(h_dtype)
            name = carry + label
            checks[name] = {"H": check(f"K1 {name} H", k_h, p_h, h_tol), "d": check(f"K1 {name} d", k_d, p_d, 1e-4)}
            worst = max(worst, checks[name]["H"]["max_abs_err"], checks[name]["d"]["max_abs_err"])
            del k_h, p_h

    def plain(first, second):
        h_out, d = plain_version(h_bm, s, y, grad, updating, first, second)
        return h_out.permute(1, 2, 0).to(h_dtype), d

    # H exceeds the L2 at every served shape but bfloat16 at B = 8192, so the
    # repeats find it cold
    ms = cuda_ms(lambda: kernel(h_t, s, y, grad, updating, False, False), reps=50)
    graph_ms = graph_replay_ms(lambda: kernel(h_t, s, y, grad, updating, False, False), reps=50)
    plain_ms = cuda_ms(lambda: plain(False, False), reps=10, warmup=1)
    # least traffic: H read once and written once; s, y, g read, d written,
    # the mask read; operations: Hy (2P^2), the update (6P^2), -H+ g (2P^2)
    h_bytes = 2 if h_dtype == torch.bfloat16 else 4
    bytes_moved = batch * (2 * p * p * h_bytes + 4 * p * 4 + 1)
    operations = batch * 10 * p * p
    bound_ms, bound_by = bound(bytes_moved, operations)
    return dict(
        batch=batch, h_dtype=str(h_dtype).replace("torch.", ""), checks=checks, max_abs_err=worst,
        ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / ms, GBps=bytes_moved / ms / 1e6, library_ms=None,
        ptxas=ptxas_resources(build.build_log.get("ptxas", []), k1_symbol(h_dtype, symbol)),
    )


def k1_variant(ordering):
    """The K1' ordering's kernel (16 elements per block, the TPU sweep's
    block_b 128) and its plain version."""
    from davo_tpu_torch.ops import bfgs_update_variants as k1v

    kernel = k1v.rowloop_update_direction if ordering == "rowloop" else k1v.rowloop2_update_direction
    plain = k1v.reference_rowloop if ordering == "rowloop" else k1v.reference_rowloop2
    symbol = f"bfgs_variant_rows_kernelILb{int(ordering == 'rowloop')}E"
    return (lambda *args: kernel(*args, elements_per_block=16)), plain, symbol


# ---------------------------------------------------------------- K2 ----


def k2_operations(m, n):
    """Float32 operations of one element's value+gradient, counted line by
    line from csrc/calibration_obj.cu (an FMA counts 2; a sqrt, division,
    exp, sin, cos, comparison or select counts 1): a (view, point) term of
    view 1 costs 158 (forward 88: normalisations, Kahan distance, atan2
    polynomial; reverse 70), a term of a rotated view 104 more (Rodrigues
    forward 30, its adjoint 74); each rotated view 63 for its trigonometric
    ratios and their derivatives; the gauge rescale and its adjoint about
    5 per parameter plus 20."""
    p = 3 + 3 * n + 6 * (m - 1)
    return m * n * 158 + (m - 1) * n * 104 + (m - 1) * 63 + 5 * p + 20


def k2_inputs(batch, device, seed):
    from davo_tpu_torch.data import SceneConfig, generate_batch

    g = torch.Generator(device).manual_seed(seed)
    scenes = generate_batch(g, batch, SceneConfig(num_views=M, num_points=N), device=device)
    p = 3 + 3 * N + 6 * (M - 1)
    params = 0.3 * torch.randn(batch, p, generator=g, device=device)
    params[:, 0] += 1.0
    params[:, 5 : 3 + 3 * N : 3] += 1.0
    r0 = 3 + 3 * N + 3 * (M - 1)
    params[: batch // 8, r0:] *= 1e-3  # small angles: the Taylor branches
    params[batch // 8 : batch // 4, 0] -= 2.0  # negative focal: the exp branch
    vis = scenes.visibility_mask.float()
    u = scenes.projected_points[..., 0].permute(1, 2, 0).contiguous()
    v = scenes.projected_points[..., 1].permute(1, 2, 0).contiguous()
    return params.contiguous(), u, v, vis.permute(1, 2, 0).contiguous()


def k2_phase(batch, device):
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.ops.calibration_obj import _value_and_grad_plain, calibration_value_and_grad

    params, u, v, vis = k2_inputs(batch, device, seed=batch + 1)
    k_err, k_grad = calibration_value_and_grad(params, u, v, vis)
    torch.cuda.synchronize()
    p_err, p_grad = _value_and_grad_plain(params, u, v, vis)
    # float32 sums of 32 angles / gradient terms in another order
    checks = {"error": check("K2 error", k_err, p_err, 1e-5), "gradient": check("K2 gradient", k_grad, p_grad, 1e-4)}
    # the inputs (6 MB at B = 8192) stay in the L2 across the repeats: warm
    ms = cuda_ms(lambda: calibration_value_and_grad(params, u, v, vis), reps=100)
    graph_ms = graph_replay_ms(lambda: calibration_value_and_grad(params, u, v, vis), reps=100)
    plain_ms = cuda_ms(lambda: _value_and_grad_plain(params, u, v, vis), reps=10, warmup=1)
    p = params.shape[1]
    bytes_moved = batch * 4 * (p + 3 * M * N + 1 + p)
    operations = batch * k2_operations(M, N)
    bound_ms, bound_by = bound(bytes_moved, operations)
    return dict(
        batch=batch, checks=checks,
        max_abs_err=max(checks["error"]["max_abs_err"], checks["gradient"]["max_abs_err"]),
        ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / ms, library_ms=None, operations_per_element=k2_operations(M, N),
        ptxas=ptxas_resources(build.build_log.get("ptxas", []), f"calibration_vg_kernelILi{M}ELi{N}E"),
    )


# ---------------------------------------------------------------- K4 ----


def k4_operations(m, n):
    """Float32 operations of one element's value + directional derivative,
    counted line by line from csrc/calibration_dirderiv.cu (as
    k2_operations): a (view, point) term of view 1 costs 187 (forward 88,
    tangent 99), a term of a rotated view 107 more (Rodrigues and its
    tangent); each rotated view 75 for its trigonometric ratios, their
    derivatives and tangents; the gauge rescale 4 per coordinate plus 20."""
    return m * n * 187 + (m - 1) * n * 107 + (m - 1) * 75 + 4 * (3 * n + 3 * (m - 1)) + 20


def k4_phase(batch, device):
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.ops.calibration_obj import _value_and_dirderiv_plain, calibration_value_and_dirderiv

    params, u, v, vis = k2_inputs(batch, device, seed=batch + 2)  # small angles, f <= 0 on 1/8
    p = params.shape[1]
    direction = torch.randn(batch, p, generator=torch.Generator(device).manual_seed(batch + 3), device=device)
    vis[:, :, 0] = 0.0  # element 0 sees nothing
    params[1, 0] = 0.0  # element 1: f = 0 exactly, the exp branch's edge
    args = (params, direction, u, v, vis)
    k_err, k_dphi = calibration_value_and_dirderiv(*args)
    torch.cuda.synchronize()
    p_err, p_dphi = _value_and_dirderiv_plain(*args)
    # float32 sums of 32 angles (and of their tangents) in another order
    checks = {"error": check("K4 error", k_err, p_err, 1e-5), "dphi": check("K4 dphi", k_dphi, p_dphi, 1e-4)}
    if not (k_err[0].item() == 0.0 and k_dphi[0].item() == 0.0):
        raise AssertionError(f"K4: an element that sees nothing gave {k_err[0].item()}, {k_dphi[0].item()}")
    ms = cuda_ms(lambda: calibration_value_and_dirderiv(*args), reps=100)
    graph_ms = graph_replay_ms(lambda: calibration_value_and_dirderiv(*args), reps=100)
    plain_ms = cuda_ms(lambda: _value_and_dirderiv_plain(*args), reps=10, warmup=1)
    # each element reads its parameters, direction and M N observations
    # (u, v, vis) once and writes its error and dphi
    bytes_moved = batch * 4 * (2 * p + 3 * M * N + 2)
    operations = batch * k4_operations(M, N)
    bound_ms, bound_by = bound(bytes_moved, operations)
    return dict(
        batch=batch, checks=checks, max_abs_err=max(checks["error"]["max_abs_err"], checks["dphi"]["max_abs_err"]),
        ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        library_ms=None, operations_per_element=k4_operations(M, N),
        ptxas=ptxas_resources(build.build_log.get("ptxas", []), f"calibration_dirderiv_kernelILi{M}ELi{N}E"),
    )


# ---------------------------------------------------------------- K3 ----


def k3_inputs(b, q_len, kv_len, d, c, device, seed, masked):
    g = torch.Generator(device).manual_seed(seed)
    q = torch.randn(b, q_len, d, generator=g, device=device)
    k = torch.randn(b, kv_len, d, generator=g, device=device)
    v = torch.rand(b, kv_len, c, generator=g, device=device) * 2.0 - 1.0  # coordinates in [-1, 1]
    mask = None
    if masked:
        mask = torch.rand(b, kv_len, generator=g, device=device) > 0.3
        mask[0] = False  # problem 0: every row without a valid key
    return q, k, v, mask


def sdpa_ms(q, k, v, expected):
    """torch's scaled_dot_product_attention as the matcher would call it:
    no mask (``models/matcher.py`` passes none) and V zero-padded to the
    narrowest width the backend takes, under the first backend that takes
    the inputs in the order EFFICIENT, CUDNN, FLASH, MATH.  The pad and
    the slice back to C happen outside the timed call.  Timed as a
    yardstick, never used by the port; its error against ``expected`` is
    recorded, not checked."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4 = q[:, None], k[:, None]  # (B, heads = 1, L, E): the fused backends want 4-D
    c = v.shape[-1]
    widths = [c] + [w for w in (4, 8, 16, 32, 64) if w > c]
    backends = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION, SDPBackend.MATH]
    for backend in backends:
        for width in widths:
            v4 = torch.nn.functional.pad(v, (0, width - c))[:, None].contiguous()
            try:
                # a backend that refuses the inputs warns why, then raises
                with sdpa_kernel([backend]), warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    got = sdpa(q4, k4, v4)
                    torch.cuda.synchronize()
            except RuntimeError:
                continue
            with sdpa_kernel([backend]):
                ms = cuda_ms(lambda: sdpa(q4, k4, v4), reps=50)
            return dict(
                library_ms=ms, library_backend=backend.name, library_value_width=width,
                library_max_abs_err=(got[:, 0, :, :c] - expected).abs().max().item(),
            )
    return dict(library_ms=None, library_backend="none")


def sdpa_masked_math_ms(q, k, v):
    """scaled_dot_product_attention with an all-true boolean key mask and
    V at its own width C, which every fused backend refuses in float32:
    the MATH backend, kept beside the fair yardstick for the older records."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = q[:, None], k[:, None], v[:, None]
    mask = torch.ones(q.shape[0], 1, 1, k.shape[1], dtype=torch.bool, device=q.device)
    with sdpa_kernel([SDPBackend.MATH]):
        return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), reps=20)


def k3_phase(device):
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.ops.attention import flash_match_attention, reference_flash_attention

    checks, worst = {}, 0.0
    cases = (
        # the matcher's shape, unmasked as the path runs it
        ("served", K3_PROBLEMS, K3_CELLS, K3_CELLS, K3_DEPTH, K3_WIDTH, False),
        # random key masks, problem 0 fully masked, Q and K not multiples of 64
        ("masked_ragged", 512, 100, 150, K3_DEPTH, K3_WIDTH, True),
        ("masked_wide", 64, 37, 211, 100, 8, True),
    )
    for label, b, q_len, kv_len, d, c, masked in cases:
        q, k, v, mask = k3_inputs(b, q_len, kv_len, d, c, device, seed=b + q_len, masked=masked)
        got = flash_match_attention(q, k, v, mask)
        torch.cuda.synchronize()
        expected = reference_flash_attention(q, k, v, mask)
        # float32 sums of D products and of the softmax weights in another order
        checks[label] = check(f"K3 {label}", got, expected, 1e-5)
        if masked:
            if not bool(torch.all(got[0] == 0)):
                raise AssertionError(f"K3 {label}: a row with no valid key is not exactly zero")
            checks[label]["masked_rows_zero"] = True
        worst = max(worst, checks[label]["max_abs_err"])
    q, k, v, _ = k3_inputs(K3_PROBLEMS, K3_CELLS, K3_CELLS, K3_DEPTH, K3_WIDTH, device, seed=5, masked=False)
    ms = cuda_ms(lambda: flash_match_attention(q, k, v), reps=50)
    graph_ms = graph_replay_ms(lambda: flash_match_attention(q, k, v), reps=50)
    plain_ms = cuda_ms(lambda: reference_flash_attention(q, k, v), reps=10, warmup=1)
    library = sdpa_ms(q, k, v, reference_flash_attention(q, k, v))
    library_math_ms = sdpa_masked_math_ms(q, k, v)
    b, ql, kl, d, c = K3_PROBLEMS, K3_CELLS, K3_CELLS, K3_DEPTH, K3_WIDTH
    bytes_moved = 4 * b * (ql * d + kl * d + kl * c + ql * c)
    # the kernel's route: QK^T as three TF32 products on the tensor cores
    # (3xTF32), PV and one exp a score on the CUDA cores
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_tensor = 3 * b * 2 * ql * kl * d / PEAK_TF32_OPS_PER_S * 1e3
    t_cuda = b * (2 * ql * kl * c + ql * kl) / PEAK_F32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_tensor, t_cuda)
    bound_by = "bytes" if bound_ms == t_bytes else "operations"
    # the same work on the CUDA cores alone (the bound of the first design, which ran there)
    bound_cuda_core_ms = b * (2 * ql * kl * d + 2 * ql * kl * c) / PEAK_F32_OPS_PER_S * 1e3
    return dict(
        problems=b, queries=ql, keys=kl, depth=d, width=c, checks=checks, max_abs_err=worst,
        ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        bound_parts_ms=dict(bytes=t_bytes, tf32_tensor_cores=t_tensor, f32_cuda_cores=t_cuda),
        bound_cuda_core_ms=bound_cuda_core_ms, share_of_cuda_core_bound=bound_cuda_core_ms / ms,
        **library, library_math_ms=library_math_ms,
        library_note="SDPA unmasked, V zero-padded to library_value_width outside the timed call; "
        "library_math_ms: boolean mask, V at C, MATH backend",
        ptxas=ptxas_resources(build.build_log.get("ptxas", []), f"match_attention_kernelILi{d}ELi{c}E"),
    )


# ------------------------------------------------------------- serve ----


def serve_network(device, checkpoint=CHECKPOINT, **solver_overrides):
    from davo_tpu_torch.models import load_calibration_network
    from davo_tpu_torch.solve import BFGSConfig

    # calibration_transformer_curriculum eval solver: strong Wolfe,
    # 100 iterations, 50 probes, error threshold 1e-7; 8 restarts, error
    # selection (the oracle serve's and vo-eval's window solver alike)
    solver = dict(error_threshold=1e-7, iterations=100, line_search_iterations=50)
    solver.update(solver_overrides)
    return load_calibration_network(
        checkpoint, device=device, num_views=M, num_points=N, hidden_size=256,
        head="transformer", transformer_layers=6, transformer_heads=8,
        num_restarts=SERVE_RESTARTS, solver=BFGSConfig(**solver),
    )


def focal_error(params, scenes):
    focal = torch.nn.functional.elu(params[:, 0]) + 1.0
    return (focal - scenes.camera_intrinsics[:, 0]).abs()


def serve_phase(device):
    from davo_tpu_torch.camera import calibration_error
    from davo_tpu_torch.data import SceneConfig, generate_batch
    from davo_tpu_torch.ops import build

    network = serve_network(device)
    requests = []
    # the main path: every launch counter from 0 just before it
    build.reset_launch_counts()
    for seed in range(SERVE_REQUESTS):
        scenes = generate_batch(torch.Generator(device).manual_seed(seed), SERVE_SCENES, SceneConfig(), device=device)
        torch.cuda.synchronize()
        start = time.perf_counter()
        params, error = network(
            scenes.projected_points, scenes.visibility_mask,
            generator=torch.Generator(device).manual_seed(1000 + seed), return_error=True,
        )
        torch.cuda.synchronize()
        latency = time.perf_counter() - start
        guess = network.guess(scenes.projected_points, scenes.visibility_mask)
        guess_error = calibration_error(guess, scenes.projected_points, scenes.visibility_mask.float())
        if params.shape != (SERVE_SCENES, network.num_parameters) or not torch.isfinite(params).all():
            raise AssertionError(f"request {seed}: bad output shape {tuple(params.shape)} or non-finite values")
        if not error.mean() < guess_error.mean():
            raise AssertionError(f"request {seed}: the solve did not lower the error ({error.mean()} vs {guess_error.mean()})")
        requests.append(dict(
            seed=seed, latency_s=latency, mean_final_error=error.mean().item(),
            mean_guess_error=guess_error.mean().item(),
            f_error_mean=focal_error(params, scenes).mean().item(),
            guess_f_error_mean=focal_error(guess, scenes).mean().item(),
        ))
    launches = dict(build.launch_counts)
    for name in ("bfgs_update", "calibration_value_and_grad"):
        if launches[name] <= 0:
            raise AssertionError(f"the serve path never launched kernel {name}")
    return network, dict(requests=requests, launches=launches)


def small_input_reference(device):
    """The network on 32 scenes (8 restarts, 5 iterations) on the card and
    on the CPU (plain versions of both kernels): the guesses agree to 1e-4
    normwise, and the solved estimates of at least 90% of the scenes agree
    to 1e-3 (a Wolfe accept/reject decision that rounding flips sends an
    element down another path; those stay few)."""
    from davo_tpu_torch.data import SceneConfig, generate_batch

    scenes = generate_batch(torch.Generator("cpu").manual_seed(99), 32, SceneConfig(), device="cpu")
    draws = torch.randn(32, SERVE_RESTARTS - 1, 45, generator=torch.Generator("cpu").manual_seed(98))
    out = {}
    for dev in (device, torch.device("cpu")):
        net = serve_network(dev, iterations=5)
        pts, vis = scenes.projected_points.to(dev), scenes.visibility_mask.to(dev)
        guess = net.guess(pts, vis)
        solved = net(pts, vis, restart_draws=draws.to(dev))
        out[dev.type] = (guess.cpu(), solved.cpu())
    guess_check = check("small-input guess", out["cuda"][0], out["cpu"][0], 1e-4)
    diff = (out["cuda"][1] - out["cpu"][1]).abs().amax(dim=1)
    scale = out["cpu"][1].abs().amax(dim=1).clamp(min=1.0)
    agree = (diff / scale <= 1e-3).float().mean().item()
    if agree < 0.9:
        raise AssertionError(f"small input: only {agree:.2%} of scenes agree with the CPU run")
    return dict(guess=guess_check, scenes_agreeing=agree)


def _device_us(row):
    return getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0.0)


def device_busy(rows, wall_s):
    """The device's kernel seconds in a profile's ``key_averages()`` rows
    and their share of ``wall_s``.  Only the device's own rows (the
    kernels, memcpys and memsets) are summed: an operator's row also
    carries the device time of the kernels it launched, so summing every
    row counts each kernel twice (``all_rows_device_s``, kept to show it)."""
    from torch.autograd import DeviceType

    kernel_us = sum(
        _device_us(r) for r in rows
        if getattr(r, "device_type", None) == DeviceType.CUDA and not getattr(r, "is_user_annotation", False)
    )
    all_us = sum(_device_us(r) for r in rows)
    if kernel_us <= 0:
        return dict(device_kernel_s="not measured", device_busy_share="not measured", all_rows_device_s=all_us / 1e6)
    return dict(device_kernel_s=kernel_us / 1e6, device_busy_share=kernel_us / 1e6 / wall_s,
                all_rows_device_s=all_us / 1e6)


def profile_steps(step, steps=PROFILED_STEPS):
    """torch.profiler over ``steps`` calls of ``step`` (after one warm-up
    call), synchronised at the end: wall seconds, the device's kernel
    seconds and its busy share.  Only the device's activity is recorded:
    the share needs no more, and the host's operators of 5 MLP train
    steps took about 80 s to post-process on an H100 host."""
    step()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    return dict(profiled_steps=steps, profiled_wall_s=wall, **device_busy(prof.key_averages(), wall))


def profile_phase(device):
    """Where a request's time goes: torch.profiler over one request of
    1,024 scenes (8 restarts) with the solve cut to PROFILED_ITERATIONS
    iterations (the per-iteration work is the same as in the
    100-iteration serve)."""
    from davo_tpu_torch.data import SceneConfig, generate_batch

    network = serve_network(device, iterations=PROFILED_ITERATIONS)
    scenes = generate_batch(torch.Generator(device).manual_seed(7), SERVE_SCENES, SceneConfig(), device=device)

    def request():
        network(scenes.projected_points, scenes.visibility_mask, generator=torch.Generator(device).manual_seed(8))
        torch.cuda.synchronize()

    request()  # warm-up
    start = time.perf_counter()
    request()
    unprofiled = time.perf_counter() - start
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        request()
        profiled = time.perf_counter() - start
    rows = prof.key_averages()
    busy = device_busy(rows, profiled)
    by_device = sorted(rows, key=_device_us, reverse=True)[:8]
    by_host = sorted(rows, key=lambda r: r.self_cpu_time_total, reverse=True)[:8]
    atan2_calls = sum(r.count for r in rows if r.key == "aten::atan2")
    return dict(
        solver_iterations=PROFILED_ITERATIONS, wall_s=unprofiled, profiled_wall_s=profiled, **busy,
        # each plain-objective evaluation (a line-search probe round) calls
        # atan2 once per view; the restart selection calls it once more
        probe_rounds=(atan2_calls - 1) / M,
        top_device=[dict(name=r.key[:80], ms=_device_us(r) / 1e3, count=r.count) for r in by_device],
        top_host_self=[dict(name=r.key[:80], ms=r.self_cpu_time_total / 1e3, count=r.count) for r in by_host],
    )


# ---------------------------------------------------- frontend serve ----


def frontend_serve_phase(device):
    """The learned-match window path, 2 requests; then, outside the counted
    run, the comparison on request 0's windows."""
    from davo_tpu_torch.data import VOWindowConfig, generate_vo_window_batch
    from davo_tpu_torch.models import load_frontend
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import FrontendExperiment, frontend_eval_metrics, render_scene_batch

    # the front end as it was trained and validated (every gate off: top-k
    # anchor selection), where its log reads match_inlier_rate 0.971
    frontend, render_config = load_frontend(device=device)
    network = serve_network(device, checkpoint=WINDOW_CHECKPOINT)
    experiment = FrontendExperiment(render=render_config)
    torch.cuda.reset_peak_memory_stats()
    requests, first = [], None
    # the main path: every launch counter from 0 just before it
    build.reset_launch_counts()
    for seed in range(WINDOW_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        windows = generate_vo_window_batch(torch.Generator(device).manual_seed(seed), WINDOWS, VOWindowConfig(), device=device)
        images = render_scene_batch(torch.Generator(device).manual_seed(1000 + seed), windows, render_config)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = frontend(images)
        torch.cuda.synchronize()
        t2 = time.perf_counter()

        def solve():
            return network(
                out.matches, out.match_visibility,
                generator=torch.Generator(device).manual_seed(2000 + seed), return_error=True,
            )

        if seed == 0:  # K1's carry watched on the served solve: no solve of its own
            (params, error), carry_report = carry_symmetry(solve)
        else:
            params, error = solve()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        metrics = frontend_eval_metrics(out, windows, experiment)
        if images.shape != (WINDOWS, M, render_config.image_size, render_config.image_size, 3):
            raise AssertionError(f"request {seed}: images of shape {tuple(images.shape)}")
        if params.shape != (WINDOWS, network.num_parameters) or not torch.isfinite(params).all():
            raise AssertionError(f"request {seed}: bad solve output shape {tuple(params.shape)} or non-finite values")
        inlier_rate = metrics["match_inlier_rate"].item()
        if not inlier_rate >= 0.95:
            raise AssertionError(f"request {seed}: match_inlier_rate {inlier_rate} is below 0.95")
        requests.append(dict(
            seed=seed, windows=WINDOWS, latency_s=t3 - t0, generate_render_s=t1 - t0, frontend_s=t2 - t1,
            solve_s=t3 - t2, match_inlier_rate=inlier_rate, detection_loss=metrics["detection_loss"].item(),
            score_loss=metrics["score_loss"].item(), match_loss=metrics["match_loss"].item(),
            visible_match_share=out.match_visibility.float().mean().item(),
            mean_final_error=error.mean().item(), f_error_mean=focal_error(params, windows).mean().item(),
        ))
        if first is None:
            first = (windows, images, params, error)
    # read just after the main path, before anything else launches a kernel
    launches = dict(build.launch_counts)
    for name in ("bfgs_update", "calibration_value_and_grad", "match_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"the learned-match window path never launched kernel {name}")
    return dict(
        requests=requests, launches=launches, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        carry_symmetry=carry_report(), subset_comparison=subset_comparison(device, network, experiment, *first),
    )


def carry_symmetry(solve):
    """``solve()`` (served request 0's window solve, inside the counted
    run) watching K1's calls without a host synchronisation.  Returns
    ``(solve's result, report)``; ``report()``, called once the launch
    counts are read (it launches K1's plain version and K1' rowloop2),
    gives how far the carry that the solve ends with has drifted from
    symmetry, max|H - H'| / max|H| (over the batch, and the worst
    element's), and what K1's shortcut y'H = (Hy)' changes on the last
    call that updated any element, against K1's plain version and K1'
    rowloop2, which reduce y'H over the rows."""
    import importlib

    from davo_tpu_torch.ops import bfgs_update_variants as k1v
    from davo_tpu_torch.ops.bfgs_update import channel_major_plain, reference_update_direction

    solver = importlib.import_module("davo_tpu_torch.solve.bfgs")
    k1 = solver.fused_bfgs_update_direction
    seen = {"calls": 0, "last_two": []}

    def watch(*args):
        out = k1(*args)
        seen.update(calls=seen["calls"] + 1, final=out[0])
        if not args[5]:  # not the first step
            seen["last_two"] = (seen["last_two"] + [(args, out)])[-2:]
        return out

    solver.fused_bfgs_update_direction = watch
    try:
        result = solve()
    finally:
        solver.fused_bfgs_update_direction = k1

    def asymmetry(h):
        h = h.float()
        diff = (h - h.transpose(0, 1)).abs()
        return dict(
            batch=(diff.max() / h.abs().max()).item(),
            worst_element=(diff.amax(dim=(0, 1)) / h.abs().amax(dim=(0, 1))).max().item(),
        )

    def normwise(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1.0)).item()

    def report():
        # the solve goes on only while some element moved, and an element
        # that moved was updating at that step's K1 call: so of the last two
        # calls, the later one that updated any element
        args, (k1_h, k1_d) = next(c for c in reversed(seen["last_two"]) if bool(c[0][4].any()))
        plain_h, plain_d = channel_major_plain(reference_update_direction, *args)
        v_h, v_d = k1v.rowloop2_update_direction(*args)
        torch.cuda.synchronize()
        return dict(
            k1_calls=seen["calls"], h_dtype=str(args[0].dtype).replace("torch.", ""), batch=args[0].shape[-1],
            final_carry=asymmetry(seen["final"]), last_update_carry_in=asymmetry(args[0]),
            last_update_share=args[4].float().mean().item(),
            k1_against_plain=dict(h=normwise(k1_h, plain_h), d=normwise(k1_d, plain_d)),
            rowloop2_against_plain=dict(h=normwise(v_h, plain_h), d=normwise(v_d, plain_d)),
        )

    return result, report


def subset_comparison(device, network, experiment, windows, images, params, error):
    """Request 0's first 256 windows solved three ways (the same solver):
    on the top-k learned matches (taken from the request), on vo-eval's
    default front end (greedy NMS, radius 0.1; every other gate off) and
    on the oracle matches.  The NMS front end's match_inlier_rate covers
    all 1,024 windows."""
    from davo_tpu_torch.models import load_frontend
    from davo_tpu_torch.train import frontend_eval_metrics

    sub = slice(0, COMPARISON_WINDOWS)
    sub_windows = _subset(windows, sub)
    nms_frontend, _ = load_frontend(device=device, **VO_EVAL_GATES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nms_out = nms_frontend(images)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    nms_params, nms_error = network(
        nms_out.matches[sub], nms_out.match_visibility[sub],
        generator=torch.Generator(device).manual_seed(4000), return_error=True,
    )
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    oracle_params, oracle_error = network(
        sub_windows.projected_points, sub_windows.visibility_mask,
        generator=torch.Generator(device).manual_seed(3000), return_error=True,
    )
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for label, p in (("nms", nms_params), ("oracle", oracle_params)):
        if not torch.isfinite(p).all():
            raise AssertionError(f"subset comparison: the {label} solve gave non-finite values")
    comparison = dict(
        windows=COMPARISON_WINDOWS, nms_gates=VO_EVAL_GATES,
        nms_match_inlier_rate=frontend_eval_metrics(nms_out, windows, experiment)["match_inlier_rate"].item(),
        nms_visible_match_share=nms_out.match_visibility.float().mean().item(),
        nms_frontend_s=t1 - t0, nms_solve_s=t2 - t1, oracle_solve_s=t3 - t2,
        topk_mean_final_error=error[sub].mean().item(),
        topk_f_error_mean=focal_error(params[sub], sub_windows).mean().item(),
        nms_mean_final_error=nms_error.mean().item(),
        nms_f_error_mean=focal_error(nms_params, sub_windows).mean().item(),
        oracle_mean_final_error=oracle_error.mean().item(),
        oracle_f_error_mean=focal_error(oracle_params, sub_windows).mean().item(),
    )
    return comparison


def _subset(windows, sub):
    return type(windows)(*(x[sub] for x in windows))


def frontend_small_input_reference(device):
    """8 windows (rendered on the CPU) through the front end on the card and
    on the CPU: the selected anchor feature of at least 99% of the tracks
    is the same and its coordinates agree to 1e-4; then a 5-iteration
    solve (8 restarts, the same draws) of the CPU front end's matches on
    both: at least 99% of the windows agree to 1e-3."""
    from davo_tpu_torch.data import VOWindowConfig, generate_vo_window_batch
    from davo_tpu_torch.models import load_frontend
    from davo_tpu_torch.train import render_scene_batch

    windows = generate_vo_window_batch(torch.Generator("cpu").manual_seed(77), 8, VOWindowConfig(), device="cpu")
    _, render_config = load_frontend(device="cpu")
    images = render_scene_batch(torch.Generator("cpu").manual_seed(78), windows, render_config)
    outs = []
    for dev in (device, torch.device("cpu")):
        frontend, _ = load_frontend(device=dev)
        out = frontend(images.to(dev))
        # the anchor cell each track selected: its view-0 coordinates are the
        # anchor's own detection
        d2 = ((out.matches[:, 0, :, None, :] - out.points[:, 0, None, :, :]) ** 2).sum(-1)
        outs.append((out.matches.cpu(), out.match_visibility.cpu(), d2.argmin(-1).cpu()))
    (card_matches, _, card_idx), (matches, vis, cpu_idx) = outs
    same = card_idx == cpu_idx
    track_share = same.float().mean().item()
    if track_share < 0.99:
        raise AssertionError(f"small input: only {track_share:.2%} of tracks selected the same feature as on the CPU")
    coord_diff = (card_matches - matches).abs().amax(dim=(1, 3))[same].max().item()
    if coord_diff > 1e-4:
        raise AssertionError(f"small input: matched coordinates differ by {coord_diff} (tolerance 1e-4)")
    draws = torch.randn(8, SERVE_RESTARTS - 1, 45, generator=torch.Generator("cpu").manual_seed(79))
    solved = [
        serve_network(dev, checkpoint=WINDOW_CHECKPOINT, iterations=5)(
            matches.to(dev), vis.to(dev), restart_draws=draws.to(dev)
        ).cpu()
        for dev in (device, torch.device("cpu"))
    ]
    diff = (solved[0] - solved[1]).abs().amax(dim=1)
    scale = solved[1].abs().amax(dim=1).clamp(min=1.0)
    agree = (diff / scale <= 1e-3).float().mean().item()
    if agree < 0.99:
        raise AssertionError(f"small input: only {agree:.2%} of window solves agree with the CPU run")
    return dict(tracks_same_selection=track_share, max_coordinate_diff=coord_diff, windows_agreeing=agree)


# ------------------------------------------------------------- bench ----


def bench_phase(device):
    from davo_tpu_torch.data import SceneConfig, generate_batch
    from davo_tpu_torch.ops import build, make_fused_calibration_objective
    from davo_tpu_torch.solve import BFGSConfig, bfgs_solve

    g = torch.Generator(device).manual_seed(0)
    scenes = generate_batch(g, BENCH_BATCH, SceneConfig(num_views=M, num_points=N), device=device)
    p = 3 + 3 * N + 6 * (M - 1)
    guess = 0.1 * torch.randn(BENCH_BATCH, p, generator=g, device=device)
    guess[:, 0] += 1.0
    guess[:, 5 : 3 + 3 * N : 3] += 1.0
    # bench.py's solver on the accelerator: never converging, Armijo
    # backtracking capped at 6 probes, bfloat16 Hessian storage
    config = BFGSConfig(
        error_threshold=-1.0, iterations=BENCH_ITERATIONS, minimum_step=0.0,
        line_search_iterations=BENCH_PROBES, line_search_method="backtracking", hessian_dtype="bfloat16",
    )
    error_fn, vg = make_fused_calibration_objective(scenes.projected_points, scenes.visibility_mask)
    bfgs_solve(error_fn, guess, config, value_and_grad_fn=vg)  # warm-up
    build.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    solved = bfgs_solve(error_fn, guess, config, value_and_grad_fn=vg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(build.launch_counts)
    expected = dict.fromkeys(launches, 0)
    expected.update(bfgs_update=BENCH_ITERATIONS, calibration_value_and_grad=BENCH_ITERATIONS)
    if launches != expected:
        raise AssertionError(f"bench-shape solve launched {launches}, expected {expected}")
    final = error_fn(solved)
    if not torch.isfinite(solved).all() or not final.mean() < error_fn(guess).mean():
        raise AssertionError("bench-shape solve gave non-finite values or did not lower the error")
    return dict(
        batch=BENCH_BATCH, iterations=BENCH_ITERATIONS, seconds_per_solve=seconds,
        bfgs_iterations_per_second=BENCH_BATCH * BENCH_ITERATIONS / seconds,
        mean_final_error=final.mean().item(), launches=launches,
    )


# -------------------------------------------- entry points of K4, K1' ----


def fused_objective_phase(device):
    """The fused-objective entry points, counted from 0 just before them:
    the check (K2 and K4 against torch autodiff of the plain objective,
    which takes the exact atan2: differences are that approximation plus
    float32 rounding, held to 1e-3 normwise) and the slope timing."""
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.scripts import check_fused_objective, time_fused_objective

    build.reset_launch_counts()
    checked = check_fused_objective.main(device)
    timed = time_fused_objective.main(device)
    launches = dict(build.launch_counts)
    for name in ("calibration_value_and_grad", "calibration_value_and_dirderiv"):
        if launches[name] <= 0:
            raise AssertionError(f"the fused-objective entry points never launched kernel {name}")
    k2_line, k4_line = checked
    for label, diff, scale in (
        ("K2 gradient", k2_line["max_abs_grad_diff"], max(1.0, k2_line["max_abs_grad"])),
        ("K4 dphi", k4_line["max_abs_dphi_diff"], max(1.0, k4_line["max_abs_dphi"])),
        ("K2 error", k2_line["max_abs_err_diff"], 1.0),
        ("K4 error", k4_line["max_abs_err_diff"], 1.0),
    ):
        if not math.isfinite(diff) or diff / scale > 1e-3:
            raise AssertionError(f"check_fused_objective: {label} differs by {diff} from torch autodiff")
    for line in timed:
        if not math.isfinite(line["ms_per_eval"]):
            raise AssertionError(f"time_fused_objective: {line}")
    by_label = {line["evaluation"]: line["ms_per_eval"] for line in timed}
    return dict(
        check=checked, time=timed, launches=launches,
        k4_over_torch_dirderiv=by_label["K4 fused value+dirderiv"] / by_label["torch value+dirderiv"],
        k2_over_torch_grad=by_label["K2 fused value+grad"] / by_label["torch value+grad"],
    )


def k1_tune_phase(device):
    """The tuning sweep's entry point, counted from 0 just before it; it
    checks every case against its plain version before timing it."""
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.scripts import tune_bfgs_kernel

    build.reset_launch_counts()
    cases = tune_bfgs_kernel.main(device)
    launches = dict(build.launch_counts)
    for name in ("bfgs_update", "bfgs_update_rowloop", "bfgs_update_rowloop2"):
        if launches[name] <= 0:
            raise AssertionError(f"the tuning sweep never launched kernel {name}")
    return dict(cases=cases, launches=launches)


# ------------------------------------------------------------ eval v4 ----


def eval_v4_phase(device):
    """``python -m davo_tpu_torch.cli eval`` at the v4_1800 checkpoint (a
    checkpoint directory holding it as checkpoint_1800.pkl), counted from
    0 just before it; its figures beside the JAX package's log."""
    from davo_tpu_torch import cli
    from davo_tpu_torch.ops import build

    with open(V4_REFERENCE_LOG) as f:
        reference = json.loads([line for line in f if line.startswith("{")][-1])
    with tempfile.TemporaryDirectory() as checkpoint_dir:
        os.symlink(V4_CHECKPOINT, os.path.join(checkpoint_dir, "checkpoint_1800.pkl"))
        build.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = cli.run(EVAL_V4_ARGS + ["--checkpoint-dir", checkpoint_dir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    launches = dict(build.launch_counts)
    print(json.dumps(result), flush=True)  # what the CLI prints
    for name in ("bfgs_update", "calibration_value_and_grad"):
        if launches[name] <= 0:
            raise AssertionError(f"the eval entry never launched kernel {name}")
    if not all(math.isfinite(v) for v in result.values()):
        raise AssertionError(f"eval_v4: non-finite metrics {result}")
    assert_within_bands("eval_v4", result, EVAL_V4_BANDS)
    return dict(
        result=result, launches=launches, seconds_per_solve=seconds / EVAL_V4_SOLVES, solves=EVAL_V4_SOLVES,
        jax_reference=reference, jax_reference_source="artifacts/eval_v4_calib.log (256 scenes, jax.random draws)",
        bands=EVAL_V4_BANDS,
    )


def assert_within_bands(name, result, bands):
    """Fail unless each banded figure of ``result`` lies in its band."""
    outside = {k: (result[k], band) for k, band in bands.items() if not band[0] <= result[k] <= band[1]}
    if outside:
        raise AssertionError(f"{name}: figures outside their bands (figure, band): {outside}")


# ----------------------------------------------------- eval restarts ----


def jax_reference(log, case=None):
    """The JAX package's figures in one of its eval logs: the last JSON
    line, or the line of ``case`` (by its ``case`` field, or the JSON line
    after the header ``=== case ===``)."""
    with open(os.path.join(REPO, "artifacts", log)) as f:
        lines = f.read().splitlines()
    if case is None:
        return json.loads([line for line in lines if line.startswith("{")][-1])
    for i, line in enumerate(lines):
        if line.startswith("{") and json.loads(line).get("case") == case:
            return json.loads(line)
        if line.strip() == f"=== {case} ===":
            return json.loads(lines[i + 1])
    raise KeyError(f"{case!r} is not in {log}")


def restart_network(device, checkpoint, scenes, **fields):
    """The curriculum preset's network and experiment at ``checkpoint``'s
    architecture (read from its arrays), its weights loaded through a
    checkpoint directory that links it (as the eval entry reads one)."""
    import dataclasses

    from davo_tpu_torch.models import checkpoint_architecture, load_flax_weights
    from davo_tpu_torch.train import get_preset, restore_checkpoint

    with tempfile.TemporaryDirectory() as checkpoint_dir:
        os.symlink(checkpoint, os.path.join(checkpoint_dir, "checkpoint_1.pkl"))
        restored = restore_checkpoint(checkpoint_dir)
    arch = checkpoint_architecture(restored["params"])
    arch.pop("head")
    config = dataclasses.replace(
        get_preset("calibration_transformer_curriculum"), num_views=M, num_points=N, batch_size=scenes,
        **arch, **fields,
    )
    network = config.build_network(device)
    load_flax_weights(network, restored["params"], restored.get("batch_stats"))
    return network, config


def eval_restarts_phase(device):
    """The eval proposals and selections at full width: for each case the
    library's evaluate_calibration_ate on one batch of 256 scenes (one
    solve of 256 x restarts elements), its launches counted from 0 just
    before it, its figures beside the JAX package's log."""
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import evaluate_calibration_ate

    cases = []
    for name, checkpoint, fields, (log, log_case) in EVAL_RESTART_CASES:
        network, config = restart_network(device, checkpoint, EVAL_RESTART_SCENES, **fields)
        reference = jax_reference(log, log_case)
        build.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = evaluate_calibration_ate(network, config, config.seed, batches=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        launches = dict(build.launch_counts)
        for counter in ("bfgs_update", "calibration_value_and_grad"):
            if launches[counter] <= 0:
                raise AssertionError(f"eval_restarts {name}: never launched kernel {counter}")
        if not all(math.isfinite(v) for v in result.values()):
            raise AssertionError(f"eval_restarts {name}: non-finite figures {result}")
        bands = {k: (EVAL_RESTART_BAND[0] * reference[k], EVAL_RESTART_BAND[1] * reference[k])
                 for k in ("ate_rmse_mean", "f_error_mean")}
        cases.append(dict(
            case=name, scenes=EVAL_RESTART_SCENES, elements=EVAL_RESTART_SCENES * config.num_restarts, **fields,
            ate_rmse_mean=result["ate_rmse_mean"], ate_rmse_median=result["ate_rmse_median"],
            f_error_mean=result["f_error_mean"], seconds_per_solve=seconds, launches=launches,
            jax_reference={k: reference[k] for k in ("ate_rmse_mean", "ate_rmse_median", "f_error_mean")},
            jax_reference_source=f"artifacts/{log}" + (f" ({log_case})" if log_case else ""), bands=bands,
        ))
        assert_within_bands(f"eval_restarts {name}", result, bands)
        del network
        torch.cuda.empty_cache()
    return dict(cases=cases)


# ------------------------------------------------------------ training ----


def fixed_batch_experiment(batch, **fields):
    """A CalibrationExperiment whose batches are ``batch`` (moved to the
    device asked for), whatever generator draws them."""
    import dataclasses

    from davo_tpu_torch.train import CalibrationExperiment
    from davo_tpu_torch.types import CameraViewsAndPoints

    @dataclasses.dataclass(frozen=True)
    class FixedBatch(CalibrationExperiment):
        def make_batch_fn(self, device=None):
            moved = CameraViewsAndPoints(*(x.to(device) for x in batch))
            return lambda generator, batch_size: moved

    return FixedBatch(**fields)


def train_check_phase(device):
    """One train step on the card and one on the CPU, float64, from the
    same flax-style weights, the same batch and the same keep-masks (drawn
    once on the CPU): the MLP head (hidden 32) through a 3-iteration
    unrolled solve with drop-path 0.1, batch 16.  The loss, the metrics,
    the updated parameters and the running statistics agree to
    TRAIN_CHECK_TOL relative (to the largest entry of each); neither
    kernel runs (the training solve is unfused, as in the JAX package)."""
    from davo_tpu_torch.data import SceneConfig, generate_batch
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.solve import BFGSConfig
    from davo_tpu_torch.train import create_train_state, make_train_step

    batch_size, iterations = 16, 3
    batch = generate_batch(torch.Generator("cpu").manual_seed(5), batch_size,
                           SceneConfig(num_views=M, num_points=N, dtype=torch.float64), device="cpu")
    keep_masks = torch.rand(iterations, batch_size, generator=torch.Generator("cpu").manual_seed(6)) > 0.1
    config = fixed_batch_experiment(
        batch, num_views=M, num_points=N, hidden_size=32, batch_size=batch_size, dtype=torch.float64,
        solver=BFGSConfig(error_threshold=1e-7, training_error_threshold=1e-3, iterations=100,
                          training_iterations=iterations, line_search_iterations=50, drop_path_p=0.1),
    )
    out = []
    for dev in (device, torch.device("cpu")):
        state = create_train_state(config, dev)
        build.reset_launch_counts()
        metrics = make_train_step(state, config)(torch.Generator(dev).manual_seed(0), keep_masks=keep_masks)
        launches = dict(build.launch_counts)
        if any(launches.values()):
            raise AssertionError(f"train_check: the train step launched kernels {launches}")
        out.append((metrics, {k: v.detach().cpu() for k, v in state.network.state_dict().items()}))
    (metrics, weights), (cpu_metrics, cpu_weights) = out
    checks = {name: check(f"train_check {name}", metrics[name].cpu(), cpu_metrics[name], TRAIN_CHECK_TOL)
              for name in cpu_metrics}
    worst = 0.0
    for name, value in cpu_weights.items():
        if name.endswith("num_batches_tracked"):
            continue
        worst = max(worst, check(f"train_check {name}", weights[name], value, TRAIN_CHECK_TOL)["normwise_rel_err"])
    return dict(batch=batch_size, training_iterations=iterations, dtype="float64", tolerance=TRAIN_CHECK_TOL,
                metrics=checks, worst_parameter_or_statistic_normwise=worst,
                loss_card=float(metrics["loss"]), loss_cpu=float(cpu_metrics["loss"]))


def train_recipe(device, name, config, initial=None, profile=False):
    """TRAIN_STEPS train steps of ``config`` at full width (from a
    flax-style init, or from ``initial``'s weights), then
    TRAIN_VAL_BATCHES validation batches; each part's launches counted
    from 0 just before it.  With ``profile``, a torch.profiler window over
    PROFILED_STEPS more steps (after the validation) gives a step's
    device busy share."""
    from davo_tpu_torch.models import load_flax_weights
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import batch_generator, create_train_state, make_eval_step, make_train_step

    state = create_train_state(config, device)
    if initial is not None:
        load_flax_weights(state.network, initial["params"], initial.get("batch_stats"))
    train_step, eval_step = make_train_step(state, config), make_eval_step(state.network, config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    losses, seconds = [], []
    for i in range(TRAIN_STEPS):
        start = time.perf_counter()
        metrics = train_step(batch_generator(device, config.seed, 0, 0, i))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - start)
        losses.append(float(metrics["loss"]))
    train_launches = dict(build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 1e9
    build.reset_launch_counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    val = [eval_step(batch_generator(device, config.seed, 0, 1, j)) for j in range(TRAIN_VAL_BATCHES)]
    torch.cuda.synchronize()
    val_seconds = (time.perf_counter() - start) / TRAIN_VAL_BATCHES
    val_launches = dict(build.launch_counts)
    if not (math.isfinite(losses[0]) and math.isfinite(losses[-1])):
        raise AssertionError(f"train {name}: non-finite loss {losses[0]}, {losses[-1]}")
    if any(train_launches.values()):
        raise AssertionError(f"train {name}: the train steps launched kernels {train_launches}")
    for counter in ("bfgs_update", "calibration_value_and_grad"):
        if val_launches[counter] <= 0:
            raise AssertionError(f"train {name}: validation never launched kernel {counter}")
    val_metrics = {k: float(torch.mean(torch.stack([m[k] for m in val]))) for k in val[0]}
    if not all(math.isfinite(v) for v in val_metrics.values()):
        raise AssertionError(f"train {name}: non-finite validation metrics {val_metrics}")
    busy = None
    if profile:  # after the validation, which so reads the state after TRAIN_STEPS updates
        extra = itertools.count(TRAIN_STEPS)
        busy = profile_steps(lambda: train_step(batch_generator(device, config.seed, 0, 0, next(extra))))
    tail = sorted(seconds[-10:])
    return dict(
        recipe=name, steps=TRAIN_STEPS, batch=config.batch_size, training_iterations=config.solver.training_iterations,
        drop_path_p=config.solver.drop_path_p, first_loss=losses[0], last_loss=losses[-1],
        median_step_s_last10=(tail[4] + tail[5]) / 2, first_step_s=seconds[0], peak_memory_gb=peak,
        train_launches=train_launches, val_batches=TRAIN_VAL_BATCHES, val_s_per_batch=val_seconds,
        val_launches=val_launches, val_metrics=val_metrics, step_profile=busy, resume=resume_check(device, config),
    )


def resume_check(device, config):
    """fit for 1 + 1 epochs through a checkpoint directory against 2
    uninterrupted epochs (2 train batches and 1 validation batch an epoch;
    the validation solve cut to RESUME_EVAL_ITERATIONS iterations): the
    resumed epoch's metrics against the uninterrupted second epoch's."""
    import dataclasses

    from davo_tpu_torch.train import fit

    small = dataclasses.replace(
        config, epochs=2, batches_per_epoch=2, val_batches=1,
        solver=dataclasses.replace(config.solver, iterations=RESUME_EVAL_ITERATIONS),
    )
    _, whole = fit(small, device=device)
    with tempfile.TemporaryDirectory() as checkpoint_dir:
        fit(small, epochs=1, device=device, checkpoint_dir=checkpoint_dir)
        _, resumed = fit(small, device=device, checkpoint_dir=checkpoint_dir)
    worst = 0.0
    for split in ("train", "val"):
        for key, value in whole[split][1].items():
            if key != "epoch_seconds":
                worst = max(worst, abs(resumed[split][0][key] - value) / max(abs(value), 1e-30))
    if len(resumed["train"]) != 1 or worst > RESUME_TOL:
        raise AssertionError(f"resume: the resumed epoch differs from the uninterrupted one by {worst}")
    return dict(epochs="1 + 1 against 2", worst_relative_diff=worst, tolerance=RESUME_TOL, equal=worst == 0.0)


def train_phase(device):
    """The two training recipes at full width: (a) the reference recipe
    calibration_from_oracle_matches (MLP head, hidden 256, batch 64, a
    10-iteration unrolled solve with drop-path 0.1) from a flax-style
    init; (b) calibration_transformer_curriculum at v4_1800's width (embed
    448, 10 layers, 8 heads; the guess trained alone) from the v4_1800
    weights."""
    import dataclasses

    from davo_tpu_torch.models import checkpoint_architecture, load_numpy_checkpoint
    from davo_tpu_torch.train import get_preset

    reference = get_preset("calibration_from_oracle_matches")
    v4 = load_numpy_checkpoint(V4_CHECKPOINT)
    arch = checkpoint_architecture(v4["params"])
    arch.pop("head")
    curriculum = dataclasses.replace(get_preset("calibration_transformer_curriculum"), **arch)
    recipes = [train_recipe(device, "calibration_from_oracle_matches", reference, profile=True)]
    torch.cuda.empty_cache()
    recipes.append(train_recipe(device, "calibration_transformer_curriculum (v4_1800)", curriculum, initial=v4))
    return dict(recipes=recipes)


# ------------------------------------------------------- eval L-BFGS ----


def eval_lbfgs_phase(device):
    """``python -m davo_tpu_torch.cli eval --solver lbfgs`` at the v4_1800
    checkpoint, 8 restarts, 256 scenes for the ATE, counted from 0 just
    before it: K2 through the solver's value_and_grad hook, never K1 (no
    dense H); its figures beside artifacts/eval_v4_lbfgs.log within
    EVAL_RESTART_BAND."""
    from davo_tpu_torch import cli
    from davo_tpu_torch.ops import build

    reference = jax_reference("eval_v4_lbfgs.log")
    with tempfile.TemporaryDirectory() as checkpoint_dir:
        os.symlink(V4_CHECKPOINT, os.path.join(checkpoint_dir, "checkpoint_1800.pkl"))
        build.reset_launch_counts()
        torch.cuda.synchronize()
        start = time.perf_counter()
        result = cli.run(EVAL_LBFGS_ARGS + ["--checkpoint-dir", checkpoint_dir])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
    launches = dict(build.launch_counts)
    print(json.dumps(result), flush=True)  # what the CLI prints
    if launches["calibration_value_and_grad"] <= 0:
        raise AssertionError("eval_lbfgs: the L-BFGS eval never launched kernel calibration_value_and_grad")
    if launches["bfgs_update"] != 0:
        raise AssertionError(f"eval_lbfgs: L-BFGS launched the BFGS-update kernel {launches['bfgs_update']} times")
    if not all(math.isfinite(v) for v in result.values()):
        raise AssertionError(f"eval_lbfgs: non-finite metrics {result}")
    bands = {k: (EVAL_RESTART_BAND[0] * reference[k], EVAL_RESTART_BAND[1] * reference[k])
             for k in ("ate_rmse_mean", "f_error_mean")}
    assert_within_bands("eval_lbfgs", result, bands)
    return dict(
        result=result, launches=launches, seconds_per_solve=seconds / EVAL_LBFGS_SOLVES, solves=EVAL_LBFGS_SOLVES,
        jax_reference={k: reference[k] for k in ("ate_rmse_mean", "ate_rmse_median", "f_error_mean")},
        jax_reference_source="artifacts/eval_v4_lbfgs.log (256 scenes, jax.random draws)", bands=bands,
    )


# ------------------------------------------------- front-end training ----


def frontend_train_check_phase(device):
    """Two front-end train steps on the card and two on the CPU, float64, at
    a small size (32 px, descriptor and embedding 8, batch 2, dropout 0.1
    with keep masks drawn once on the CPU), from the same flax-style
    weights, windows and render noise, with a one-step warm-up, so that
    the first update's rate is 0 (as in the JAX package) and the second's
    is the peak: each step's metrics, then the parameters, their change
    over the two steps, AdamW's two moments and the BatchNorm statistics
    agree to FRONTEND_TRAIN_CHECK_TOL (each metric relative to itself;
    each kind of tensor normwise over the network, in the 2-norm); no
    kernel runs (the training matcher is the plain softmax, as in
    the JAX package).  On the card torch's AdamW takes its foreach route,
    on the CPU its loop over the parameters."""
    from davo_tpu_torch.data import RenderConfig, VOWindowConfig, generate_vo_window_batch
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import FrontendExperiment, create_frontend_state, draw_render_noise
    from davo_tpu_torch.train import make_frontend_train_step
    from davo_tpu_torch.types import CameraViewsAndPoints

    batch, size, steps = 2, 32, 2
    config = FrontendExperiment(
        descriptor_channels=8, embedding_size=8, batch_size=batch, warmup_steps=1,
        window=VOWindowConfig(dtype=torch.float64), render=RenderConfig(image_size=size, dtype=torch.float64),
    )
    g = torch.Generator("cpu").manual_seed(8)
    cells = (size // 8) ** 2
    draws = [dict(
        windows=generate_vo_window_batch(g, batch, config.window, device="cpu"),
        noise=draw_render_noise(g, batch, M, N, config.render, torch.device("cpu")),
        dropout_mask=torch.rand(batch * (M - 1), cells, cells, generator=g) < 0.9,
    ) for _ in range(steps)]
    out = []
    for dev in (device, torch.device("cpu")):
        state = create_frontend_state(config, dev, dropout=0.1)
        initial = {k: p.detach().cpu().clone() for k, p in state.network.named_parameters()}
        train_step, _ = make_frontend_train_step(state, config)
        build.reset_launch_counts()
        metrics = [train_step(
            windows=CameraViewsAndPoints(*(x.to(dev) for x in d["windows"])),
            noise={k: {n: x.to(dev) for n, x in v.items()} for k, v in d["noise"].items()},
            dropout_mask=d["dropout_mask"].to(dev),
        ) for d in draws]
        if any(build.launch_counts.values()):
            raise AssertionError(f"frontend_train_check: the train steps launched kernels {dict(build.launch_counts)}")
        tensors = {}
        for k, v in state.network.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                kind = "batch_norm_statistics" if "running_" in k else "parameters"
                tensors[kind, k] = v.detach().cpu()
        for k, p in state.network.named_parameters():
            adam = state.optimizer.state[p]
            tensors["updates", k] = p.detach().cpu() - initial[k]
            tensors["first_moments", k] = adam["exp_avg"].cpu()
            tensors["second_moments", k] = adam["exp_avg_sq"].cpu()
        out.append((metrics, tensors))
    (metrics, tensors), (cpu_metrics, cpu_tensors) = out

    checks = [{name: relative_error(metrics[i][name], value) for name, value in step.items()}
              for i, step in enumerate(cpu_metrics)]
    # each kind normwise over the whole network, in the 2-norm: the key
    # projection's bias has a gradient of 0 but for rounding (softmax
    # ignores a shift of a query's logits), which AdamW turns into updates
    # of lr * noise / eps on either side; over the network's update that
    # noise weighs what it is, against its own largest entry it is all
    squares = {}
    for (kind, name), value in cpu_tensors.items():
        err, ref = squares.get(kind, (0.0, 0.0))
        diff = tensors[kind, name].double() - value.double()
        squares[kind] = (err + float(torch.sum(diff * diff)), ref + float(torch.sum(value.double() ** 2)))
    normwise = {kind: math.sqrt(err / ref) for kind, (err, ref) in squares.items()}
    failed = [(f"step {i} {name}", e) for i, step in enumerate(checks) for name, e in step.items()]
    failed = [(name, e) for name, e in failed + list(normwise.items()) if not e <= FRONTEND_TRAIN_CHECK_TOL]
    if failed:
        raise AssertionError(f"frontend_train_check: beyond {FRONTEND_TRAIN_CHECK_TOL}: {failed}")
    for name in ("matcher.query.weight", "detector.enc1_a.conv.weight"):
        if not float(cpu_tensors["updates", name].abs().max()) > 0:
            raise AssertionError(f"frontend_train_check: the second update did not move {name}")
    return dict(batch=batch, image_size=size, width=8, dropout=0.1, dtype="float64", steps=steps,
                warmup_steps=config.warmup_steps, learning_rate=config.learning_rate,
                weight_decay=config.weight_decay, tolerance=FRONTEND_TRAIN_CHECK_TOL,
                metrics=checks, normwise=normwise,
                key_bias_update_max={side: float(t["updates", "matcher.key.bias"].abs().max())
                                     for side, t in (("card", tensors), ("cpu", cpu_tensors))},
                loss_card=[float(m["loss"]) for m in metrics], loss_cpu=[float(m["loss"]) for m in cpu_metrics])


def frontend_reference_curve():
    """The JAX package's fit-frontend run (frontend_v4, 96 px): per epoch
    its train loss, validation loss and match_inlier_rate."""
    curve = {}
    with open(FRONTEND_REFERENCE_LOG) as f:
        for line in f:
            record = json.loads(line)
            if record.get("split") in ("train", "val"):
                entry = curve.setdefault(record["epoch"], {})
                entry[f"{record['split']}_loss"] = record["loss"]
                if record["split"] == "val":
                    entry["match_inlier_rate"] = record["match_inlier_rate"]
    return curve


def frontend_train_phase(device):
    """fit_frontend at the frontend_v4 recipe's full width from a
    flax-style init for FRONTEND_EPOCHS epochs, its launches read per split
    through fit_frontend's log_fn (counted from 0 just before the run, read
    and reset at each split's log); then, outside the counted run, each
    train step timed alone, a profiler window over PROFILED_STEPS steps,
    and the checkpoint round trip (saved as fit-frontend saves it, read by
    load_frontend, its eval forward equal to the trained module's)."""
    import dataclasses

    from davo_tpu_torch.data import RenderConfig, VOWindowConfig, generate_vo_window_batch
    from davo_tpu_torch.models import load_frontend
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import (
        FrontendExperiment,
        batch_generator,
        fit_frontend,
        make_frontend_train_step,
        render_scene_batch,
        save_frontend_checkpoint,
    )

    config = dataclasses.replace(
        FrontendExperiment(), epochs=FRONTEND_EPOCHS, render=RenderConfig(image_size=FRONTEND_IMAGE_SIZE)
    )
    reference = frontend_reference_curve()
    launches = {"train": [], "val": []}
    epochs = []

    def log_fn(split, epoch, metrics):
        launches[split].append(build.launch_counts["match_attention"])
        build.reset_launch_counts()
        if split == "val":
            train = history_so_far[-1]
            epochs.append(dict(
                epoch=epoch, train_loss=train["loss"], val_loss=metrics["loss"],
                match_inlier_rate=metrics["match_inlier_rate"], epoch_seconds=train["epoch_seconds"],
                jax=reference.get(epoch),
            ))
            print(json.dumps({"frontend_train_epoch": epochs[-1]}), flush=True)
        else:
            history_so_far.append(metrics)

    history_so_far = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    start = time.perf_counter()
    state, history = fit_frontend(config, log_fn=log_fn, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() / 1e9
    if any(launches["train"]):
        raise AssertionError(f"frontend_train: the train steps launched K3 {launches['train']}")
    if not all(n > 0 for n in launches["val"]):
        raise AssertionError(f"frontend_train: a validation never launched K3 {launches['val']}")
    last = epochs[-1]
    ref = reference[last["epoch"]]
    loss_band = (FRONTEND_LOSS_BAND[0] * ref["val_loss"], FRONTEND_LOSS_BAND[1] * ref["val_loss"])
    if not (math.isfinite(last["val_loss"]) and loss_band[0] <= last["val_loss"] <= loss_band[1]):
        raise AssertionError(f"frontend_train: validation loss {last['val_loss']} outside {loss_band}")
    inlier_floor = FRONTEND_INLIER_FLOOR * ref["match_inlier_rate"]
    if not last["match_inlier_rate"] >= inlier_floor:
        raise AssertionError(f"frontend_train: match_inlier_rate {last['match_inlier_rate']} below {inlier_floor}")

    # outside the counted run: each step timed alone, then a profiler window
    train_step, _ = make_frontend_train_step(state, config)
    step_seconds = []
    for i in range(FRONTEND_TIMED_STEPS):
        generator = batch_generator(device, config.seed, FRONTEND_EPOCHS, 0, i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(generator)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
    extra = itertools.count(FRONTEND_TIMED_STEPS)
    busy = profile_steps(lambda: train_step(batch_generator(device, config.seed, FRONTEND_EPOCHS, 0, next(extra))))

    # the checkpoint round trip
    windows = generate_vo_window_batch(torch.Generator(device).manual_seed(5), 64, VOWindowConfig(), device=device)
    images = render_scene_batch(torch.Generator(device).manual_seed(6), windows, config.render)
    trained = state.network(images, training=False)
    with tempfile.TemporaryDirectory() as checkpoint_dir:
        save_frontend_checkpoint(checkpoint_dir, len(history["train"]), state.network, config)
        loaded, render = load_frontend(checkpoint_dir, device=device)
    reloaded = loaded(images)
    round_trip = max(float((getattr(reloaded, k).float() - getattr(trained, k).float()).abs().max())
                     for k in ("points", "scores", "matched", "matches", "match_visibility"))
    if round_trip != 0.0 or render.image_size != FRONTEND_IMAGE_SIZE:
        raise AssertionError(f"frontend_train: the reloaded checkpoint differs by {round_trip}")
    tail = sorted(step_seconds)
    return dict(
        epochs=epochs, recipe=dict(batch=config.batch_size, batches_per_epoch=config.batches_per_epoch,
                                   val_batches=config.val_batches, image_size=FRONTEND_IMAGE_SIZE,
                                   learning_rate=config.learning_rate, warmup_steps=config.warmup_steps),
        fit_seconds=seconds, epoch_seconds=[e["epoch_seconds"] for e in epochs],
        median_step_s=(tail[len(tail) // 2 - 1] + tail[len(tail) // 2]) / 2, peak_memory_gb=peak,
        k3_launches_train=launches["train"], k3_launches_val=launches["val"],
        launches=dict(match_attention=sum(launches["val"])), step_profile=busy,
        bands=dict(val_loss=loss_band, match_inlier_rate_floor=inlier_floor, epoch=last["epoch"]),
        jax_reference_source="artifacts/frontend_v4_metrics.jsonl (jax.random draws, 600 epochs)",
        checkpoint_round_trip_max_diff=round_trip,
    )


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.utils.precision import full_f32_matmuls

    device = torch.device("cuda")
    full_f32_matmuls()

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    build.load_library()
    emit("build", build_seconds=build.build_log.get("seconds"), ptxas=build.build_log.get("ptxas"),
         seconds=time.perf_counter() - t0)

    results = {}
    for label, fn in (
        ("k1_serve_f32", lambda: k1_phase(SERVE_SCENES * SERVE_RESTARTS, torch.float32, device)),
        ("k1_bench_f32", lambda: k1_phase(BENCH_BATCH, torch.float32, device)),
        ("k1_bench_bf16", lambda: k1_phase(BENCH_BATCH, torch.bfloat16, device)),
        ("k1_val_f32", lambda: k1_phase(VAL_BATCH, torch.float32, device)),
        ("k2_serve", lambda: k2_phase(SERVE_SCENES * SERVE_RESTARTS, device)),
        ("k2_bench", lambda: k2_phase(BENCH_BATCH, device)),
        ("k2_val", lambda: k2_phase(VAL_BATCH, device)),
        ("k3", lambda: k3_phase(device)),
        ("k4_bench", lambda: k4_phase(BENCH_BATCH, device)),
        ("k4_serve", lambda: k4_phase(SERVE_SCENES * SERVE_RESTARTS, device)),
        ("k1v_rowloop", lambda: k1_phase(BENCH_BATCH, torch.float32, device, k1_variant("rowloop"))),
        ("k1v_rowloop2", lambda: k1_phase(BENCH_BATCH, torch.float32, device, k1_variant("rowloop2"))),
    ):
        t0 = time.perf_counter()
        results[label] = fn()
        emit(label, card=smi, **results[label], seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _, serve = serve_phase(device)
    emit("serve", card=smi, scenes_per_request=SERVE_SCENES, restarts=SERVE_RESTARTS, **serve,
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    emit("serve_small_input_reference", **small_input_reference(device), seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    emit("serve_profile", card=smi, **profile_phase(device), seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    frontend_serve = frontend_serve_phase(device)
    emit("frontend_serve", card=smi, restarts=SERVE_RESTARTS, **frontend_serve,
         seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    emit("frontend_small_input_reference", **frontend_small_input_reference(device), seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    emit("bench", card=smi, **bench_phase(device), seconds=time.perf_counter() - t0)

    paths = {"frontend_serve": frontend_serve}
    for label, fn in (
        ("fused_objective", lambda: fused_objective_phase(device)),
        ("k1_tune", lambda: k1_tune_phase(device)),
        ("eval_v4", lambda: eval_v4_phase(device)),
        ("eval_restarts", lambda: eval_restarts_phase(device)),
        ("train_check", lambda: train_check_phase(device)),
        ("train", lambda: train_phase(device)),
        ("eval_lbfgs", lambda: eval_lbfgs_phase(device)),
        ("frontend_train_check", lambda: frontend_train_check_phase(device)),
        ("frontend_train", lambda: frontend_train_phase(device)),
    ):
        t0 = time.perf_counter()
        paths[label] = fn()
        emit(label, card=smi, **paths[label], seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()

    # launches: each kernel's count on the path that drives it, counted
    # from 0 just before the path and read just after: K1-K3 on the
    # learned-match window requests (without their comparison), K4 on the
    # fused-objective entry points, K1' on the tuning sweep; beside it, its
    # count on every path that launched it (K2 on the L-BFGS eval, K3 in
    # the front end's validation)
    kernels = []
    for name, label, path, counter, source, replaces in (
        ("K1 bfgs_update", "k1_serve_f32", "frontend_serve", "bfgs_update", "davo_tpu_torch/csrc/bfgs_update.cu",
         "davo_tpu/ops/bfgs_update.py:112"),
        ("K2 calibration_value_and_grad", "k2_serve", "frontend_serve", "calibration_value_and_grad",
         "davo_tpu_torch/csrc/calibration_obj.cu", "davo_tpu/ops/calibration_obj.py:124"),
        ("K3 flash_match_attention", "k3", "frontend_serve", "match_attention",
         "davo_tpu_torch/csrc/match_attention.cu", "davo_tpu/ops/attention.py:126"),
        ("K4 calibration_value_and_dirderiv", "k4_bench", "fused_objective", "calibration_value_and_dirderiv",
         "davo_tpu_torch/csrc/calibration_dirderiv.cu", "davo_tpu/ops/calibration_obj.py:179"),
        ("K1' rowloop", "k1v_rowloop", "k1_tune", "bfgs_update_rowloop",
         "davo_tpu_torch/csrc/bfgs_update_variants.cu", "scripts/tune_bfgs_kernel.py:122"),
        ("K1' rowloop2", "k1v_rowloop2", "k1_tune", "bfgs_update_rowloop2",
         "davo_tpu_torch/csrc/bfgs_update_variants.cu", "scripts/tune_bfgs_kernel.py:122"),
    ):
        r = results[label]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[path]["launches"][counter], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            # every path that launched it, each counted from 0 just before it
            launches_by_path={p: paths[p]["launches"][counter] for p in LAUNCH_PATHS
                              if paths[p]["launches"].get(counter, 0) > 0},
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
