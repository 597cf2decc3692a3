"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its seconds:

1. device   the card's name, count and power limit (nvidia-smi);
2. build    nvcc builds the port's CUDA kernels (ptxas's register, stack
            and spill lines);
3. k1, k2   each kernel against its plain PyTorch version on the card, at the
            serve shape (B = 8192, also 32 restarts of 256 scenes), the bench
            shape (B = 16384), the trainer's validation batch (B = 64),
            vo-eval's bootstrap solve (B = 8), its stacked windows (B = 56),
            K1 at correct_scale_drift's P = 15, B = 1, at the learned
            solvers' comparison (B = 256), at the gen-1 protocol solve's
            P = 44, B = 64, at eval-seq's default 32 points (P = 117,
            its two-pass route, B = 5) and at the eval entry's 64 scenes x 8
            restarts (B = 512): error
            against the stated tolerance, time by CUDA events (``ms``: the
            wrapper's launches one by one from the host, as the solver makes
            them; ``graph_ms``: the same launches replayed from a CUDA graph,
            the card's time without the host's), the least time the card
            could take (bound), the share of it reached (by ``ms``), and the
            timed kernel's registers and spill bytes from ptxas;
   k3       the attention kernel against its plain version at the matcher's
            shape (3,072 problems of 144 x 144, D = 64, C = 2), at vo-eval's
            (15 and 3 problems; 21, the stacked windows), at the 64-px front
            ends' 8 x 8 cells (3,072 and 48 problems of 64 x 64: the orbax
            phase's frontend_v2 request and frontend_v3 batch) and on masked,
            ragged inputs; its time
            beside the plain version's and beside torch's
            scaled_dot_product_attention as the matcher would call
            it (timed only as a yardstick); its bound on the tensor cores
            and, apart, on the CUDA cores alone;
   k4       the value + directional derivative kernel against its plain
            version at B = 16384 and 8192, with an element that sees nothing
            and elements with f <= 0, as k2;
   k2, k4 at other scene sizes  the general kernels every size but (4, 8)
            takes: eval-seq's default (4, 32) at its batch (B = 5) and
            (4, 32), (3, 8), (6, 16) at B = 8192, each checked and timed as
            above;
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
            and a torch.profiler breakdown of one request (3 iterations);
5. frontend_serve  learned-match window calibration: 2 requests of 1,024 VO
            windows generated and rendered at 96 px on the card, the front end
            (frontend_v4 weights, every gate off as it was validated: U-Net
            detector, top-k anchors, attention matcher through K3) and the
            window solver (vo_windows_transformer_v2_600, 8 restarts) on its
            matches; latency split, match_inlier_rate, errors, launch counts;
            request 0's solve watching K1's carry (its drift from symmetry,
            and, once the counts are read, what K1's y'H = (Hy)' changes
            on it); then, outside the counted run, request 0's first 16
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
            batches of 64 scenes; its JSON, the seconds per solve and the
            comparison with artifacts/eval_v4_calib.log;
10. eval_restarts  the eval proposals and selections on 256 scenes a case, one
            solve each through the library's evaluate_calibration_ate: v4_1800
            with 32 noise restarts and basin selection, with 8 permutation and
            with 8 input-noise restarts (error selection), and the
            v5_tokens8 weights (8 readout tokens, read by the port's Orbax
            reader from artifacts/ckpt_v5_tokens/checkpoint_1800, the store
            calibration_transformer_v5_tokens8.pkl was exported from,
            architecture read from its arrays) with its tokens as the 8
            starts; ATE and f_error beside
            the JAX package's logs, seconds per solve, launches;
11. train_check  two train steps (MLP head, 3-iteration unrolled solve,
            drop-path with injected keep-masks, a one-step warm-up, float64)
            on the card against the CPU: each step's loss and metrics, then
            the parameters, their update, both AdamW moments and the running
            statistics, each kind normwise over the network;
12. train   each calibration recipe at full width: 12 train steps and 1
            validation batch (the reference recipe's MLP head through its
            10-iteration unrolled solve, from a flax-style init; the curriculum
            transformer at v4_1800's width from its weights): losses, seconds
            per step, peak device memory, K1/K2 launches (none in the train
            steps, whose solve is unfused as in the JAX package) and a
            checkpoint round trip through fit (1 + 1 against 2 epochs); the
            reference recipe's step also under a torch.profiler window of 5
            more steps after its validation (its device busy share);
13. eval_lbfgs  the eval entry with --solver lbfgs at v4_1800 (8 restarts, one
            eval batch and one ATE batch of 64 scenes): K2 launched through
            the solver's value+gradient hook, K1 never (L-BFGS has no dense
            H); ATE and f_error beside artifacts/eval_v4_lbfgs.log, seconds per
            solve;
14. frontend_train_check  two front-end train steps (32 px, width 8, dropout
            0.1 with injected masks, a one-step warm-up, float64) on the
            card against the CPU: metrics, updated parameters, both AdamW
            moments and BatchNorm statistics;
15. frontend_train  the frontend_v4 recipe at full width (batch 16, 64 steps
            and 8 validation batches an epoch, 96 px) from a flax-style
            init, the logged run's config checked field by field against
            artifacts/frontend_v4_metrics.jsonl's (600 epochs: its
            warm-up/cosine schedule) and stopped after 12 epochs
            (fit_frontend's loop): per-epoch losses and match_inlier_rate
            beside the log's, K3 launches (0 in the train steps, > 0 in each
            validation), peak memory; the same 12 epochs from seeds 1 and 2,
            every seed's every epoch within a band of the log's; then each
            step timed alone, a profiler window of 5 steps, and the
            checkpoint round trip (saved as fit-frontend saves it, read back
            by load_frontend);
16. vo_eval  (in the first of two side processes, both started before
            eval_v4 and read here: they run beside phases 9-15, which time
            no kernel; the first runs phases 16, 17 and 21, the second 18,
            19, 20 and 22)
            learned VO from pixels through the port's vo-eval code at the
            official recipe (vo_windows_transformer_v6_verified, frontend_v4
            at 96 px with the verification gates, 16 frames of 8 points, 3
            bootstraps, ba_irls 2, no refinement), trial 0 (a generator
            seeded 100): ATE beside the JAX log's trial 0, seconds split into
            front end, bootstrap solves and the rest, peak memory, the
            chosen bootstrap and every bootstrap's cost, K1-K3 launches
            (each > 0); then the accumulator on fixed clean inputs (10
            frames, junk detections, every robustness option), the card in
            float32 against the CPU in float64;
17. vo_windows  (in the same process, after vo_eval) the JAX CLI's
            vo-eval default (windows pipeline, oracle
            matches, global stitch, refinement) at v6_verified's width, trial 0
            (a generator seeded 100): the 7 windows solved in one stacked call
            (K1 and K2 at 56 elements), the refined ATE, K1/K2 launches (each
            > 0); from the same window solves, the stitched ATE under chain,
            global and robust, multistart 4 with the float64 polish (and that
            polish on the card against the CPU's, float64, to 1e-9),
            correct_scale_drift on the global stitch (ATE before and after;
            K1 at P = 15, B = 1, launched); the oracle-guess windows stitched
            and refined in float32 (ATE within 1e-4); learned matches
            (frontend_v4, the official gates: K3 launched, ATE finite); the
            seconds split, peak memory, beside artifacts/eval_v3_vo.log,
            eval_v3_vo_raw.log, eval_stitch_compare.log and
            eval_learned_v3.log;
18. orbax   (in the second side process) four of the JAX
            package's Orbax stores (ckpt_frontend_v2, v3, v4 and
            ckpt_v5_tokens/checkpoint_1800; checkpoint_600 is read by
            tests/test_torch_orbax.py only) read once each by the port's
            reader on the card's host, which has no zstd, tensorstore or
            Orbax: seconds and MB/s each; v4 against
            davo_tpu_torch/weights/frontend_v4.npz and v5_tokens/1800
            against calibration_transformer_v5_tokens8.pkl (through the
            pickle's digest, time_orbax_reads.PICKLE_DIGESTS), bit for bit;
            then frontend_v2 (8 points, 64 px) read from its
            Orbax directory in one learned-match window request (1,024
            windows, the window solver at 8 restarts: K3, then K1 and K2),
            one validation batch of frontend_v3's recipe (16 windows of 16
            points: K3), and cli eval --checkpoint-dir
            artifacts/ckpt_v5_tokens (embed 384, 8 layers, 8 tokens as the
            restarts, an eval and an ATE batch of 64: K1 and K2), each
            beside its JAX log within a band;
19. orbax_write  (in the second side process, after orbax) the port's Orbax
            writer: the same four stores read, written twice (the faster
            write timed: seconds and MB/s on the card's host) and read back,
            one SHA-256 tree digest each side; cli fit at the reference
            recipe's full width (calibration_from_oracle_matches, batch 64),
            cut by a --config file to 2 epochs of 2 batches, into Orbax
            directories: 2 epochs whole, and 1 epoch by fit then 1 by cli
            fit resuming from the written directory (the resumed epoch
            against the whole run's second to RESUME_TOL, opt_state in the
            JAX chain's layout); cli eval --checkpoint-dir on the written
            directory (an eval and an ATE batch of 64: K1 and K2);
            fit-frontend at frontend_v4's recipe cut to one epoch of 2
            steps, read back by load_frontend (weights and matches bit for
            bit the trained module's) and served in one learned-match window
            request (1,024 windows: K3, K1 and K2);
20. calib_curriculum  (in the second side process, after orbax_write) the v2
            calibration curriculum (calibration_transformer_curriculum at
            embed 256, 6 layers, 8 heads; 600 epochs of 128 batches of 64:
            its schedule) through fit_fov_curriculum, stopped after 6 epochs
            of its first stage (50-80 degrees), validation cut from 16
            batches to 1 (the eval solve: K1 and K2 launched), each epoch's
            train loss within a band of artifacts/runs/calib_v2_metrics.jsonl's;
21. eval_seq  (in the first side process, after vo_windows) python -m
            davo_tpu_torch.cli eval-seq on tests/fixtures:
            compare mode (TUM estimate against ground truth), oracle VO and
            learned VO (v6_verified, 8 points, windows of 4, 1 restart, the
            front end with eval-seq's gates; K1-K3 launched) along the KITTI
            file; and learned VO at the CLI's default 32 points (v6's
            architecture at 4 x 32 with random weights from a seed, a
            32-point front end after one fit-frontend step; K1 at P = 117,
            K2 at (4, 32) and K3 launched, its ATE and RPE finite);
22. learned_solver  (in the second side process, after calib_curriculum)
            the trained MLP solver of
            artifacts/learned_solver_descent_v2.pkl (hidden 256, 5 recurrent
            steps) against BFGS at 5 and 20 iterations on 2 batches of 256
            scenes (compare_with_bfgs: K1 at B = 256, P = 45), each row beside
            learned_solver_descent3.log's table; the logged epoch 0 (64
            batches of 256, each JAX run's recorded config) of each solver
            type (MLP and transformer with the descent loss, the direction
            gate inside the differentiable BFGS solve), each final error
            within a band of the JAX run's epoch 0; the trained gate's
            comparison (K1 with direction_fn);
23. gen1_train  one bfgs_solver_only_error_gradient train step on the card
            against the CPU (float64 asserted, float32 reported), each gen-1
            preset's steps at its batch (seconds a step, peak memory, losses
            finite, no kernel), and the protocol solver on 64
            PinholeCameraModelL1 objectives (K1 at P = 44) against the CPU;
24. distorted  python -m davo_tpu_torch.cli eval-distorted at its defaults
            (Brown-Conrady LM, 4 batches of 16 scenes) and refine_distorted at
            the JAX bench's size (4,096 scenes of 32 points, 60 LM iterations,
            float32, CPU-drawn) beside artifacts/distorted_bench_r5b.log: the
            four figures (the bench's in bands from a CPU run of the same
            draws), seconds per LM iteration, TF32 off; 16 scenes in float64
            on the card against the CPU (1e-9); the closed-form Jacobian
            against jacfwd (float32, 1e-5); no kernel (LM is plain PyTorch);
25. track_sequence  frontend_v4 (vo_eval's gates) tracking 4 of vo_eval's
            16-frame orbits sequentially (K3 at 4 problems of 8 track queries
            against 144 cells, once a frame after the first) and through the
            anchor path: each frame's share of tracks that keep their world
            point; K3 at the tracking shape against its plain version, timed;
26. infra   fit --config configurations/mlp_guess_config.yaml (1 epoch of 2
            batches, TensorBoard on) registered in a temporary registry, read
            back by runs list/show/compare; presets; a profiling.trace of one
            served BFGS iteration naming K1 and K2; the served network's
            weight_summaries;
27. multidevice  the multi-device layer on a one-rank NCCL group (the
            machine has one card): distributed_schur_ba and
            distributed_schur_ba_2d (1 x 1) against schur_ba_solve (float64,
            1e-12), distributed_stitch_windows against the same function on
            a gloo group on the CPU (1e-12), one make_dp_train_step step
            against make_train_step (float32, 1e-6); the collectives each
            issued;
28. the kernels line (with each kernel's launches on every path that ran
   it), then the last line:
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any mismatch beyond tolerance, a failed build or launch, or a kernel a
path never launched raises, and the script exits non-zero.  Without a
card it exits non-zero before doing anything.  Each path's launch counts
are set to 0 just before it and read just after: K1, K2 and K3 from the
learned-match window path, K4 from the fused-objective entry points, K1'
from the tuning sweep, K2 from the L-BFGS eval, K3 from the front end's
validation (its train steps read 0), K1-K3 from the vo-eval trial,
K1 and K2 from the windows trial, K1 from correct_scale_drift, K1-K3
from the windows trial on learned matches and from eval-seq's learned VO
(at 8 and at 32 points), K1 from the learned solvers' comparisons and from the gen-1 protocol
solve, K3 from the sequential tracking, K1-K3 from frontend_v2's request
read from Orbax, K3 from frontend_v3's batch and K1 and K2 from the eval
at v5_tokens, K1 and K2 from the eval of the port-written directory,
K1-K3 from the request served by the port-written front end and K1 and
K2 from the v2 curriculum's validation.
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
import traceback
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
# the comparison solves 16 windows: its oracle solve took 77 s at 256 and
# 27 s at 64 (every element through 100 Wolfe iterations), which the
# vo_eval phase's time cannot spare within the run's limit
WINDOWS, WINDOW_REQUESTS, COMPARISON_WINDOWS = 1024, 2, 16
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
# v5_tokens8 through the Orbax reader: the store's latest step (1800) is the
# pickle calibration_transformer_v5_tokens8.pkl bit for bit
V5_CHECKPOINT = os.path.join(REPO, "artifacts", "ckpt_v5_tokens")
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
# training: two steps on the card against the CPU (float64), then each
# recipe's steps, validation and a checkpoint round trip
TRAIN_CHECK_TOL = 1e-8
# one validation batch a recipe: each costs 11-13 s of the run's time
# limit; 12 steps leave the median of the last 10 clear of the first
TRAIN_STEPS, TRAIN_VAL_BATCHES = 12, 1
RESUME_EVAL_ITERATIONS, RESUME_TOL = 10, 1e-6
# a torch.profiler window over this many train steps gives a step's
# device busy share; the serve profile's solve runs PROFILED_ITERATIONS
# (the profiler's post-processing of a 5-iteration solve took about 40 s)
PROFILED_STEPS, PROFILED_ITERATIONS = 5, 3
# the eval entry with L-BFGS at v4_1800: 8 restarts, one eval batch and
# one ATE batch of 64 scenes (eval_v4_lbfgs.log's ATE is over 256; a solve
# costs 20-30 s of host work whatever its scenes, so the run keeps within
# its limit with one; the band is 0.6-1.5 times the log's)
EVAL_LBFGS_ARGS = [
    "eval", "--preset", "calibration_transformer_curriculum", "--hidden-size", "448",
    "--transformer-layers", "10", "--transformer-heads", "8", "--restarts", "8",
    "--batch-size", "64", "--batches", "1", "--ate-batches", "1", "--solver", "lbfgs",
]
EVAL_LBFGS_SOLVES = 1 + 1
# the front end's training: two steps on the card against the CPU (float64,
# a small size), then the frontend_v4 recipe at full width (4 views x 8
# points, select 8, descriptor and embedding 64, batch 16, 64 batches and 8
# validation batches an epoch, 96 px, learning rate 3e-4, warm-up 200)
# beside artifacts/frontend_v4_metrics.jsonl: the logged run's config
# (600 epochs, so its warm-up/cosine schedule spans 38,400 steps) stopped
# after FRONTEND_EPOCHS epochs, for seed 0 (the counted run) and
# FRONTEND_SPREAD_SEEDS more
FRONTEND_TRAIN_CHECK_TOL = 1e-8
FRONTEND_EPOCHS, FRONTEND_IMAGE_SIZE = 12, 96
FRONTEND_SPREAD_SEEDS = (1, 2)
FRONTEND_TIMED_STEPS = 20
# each epoch's validation figures of every seed, times the JAX log's at
# the same epoch: seeds 0-2 on an H100 read 0.70-1.05 and 0.70-1.06 (loss),
# 0.62-2.22 and 0.56-2.07 (match_inlier_rate) over epochs 0-11 in two runs
# (the card's runs are not bit for bit alike; the JAX run lies inside the
# seeds' spread but at epoch 5, 0.0005 under it, in the first)
FRONTEND_BANDS = {"val_loss": (0.6, 1.25), "match_inlier_rate": (0.4, 3.0)}
FRONTEND_REFERENCE_LOG = os.path.join(REPO, "artifacts", "frontend_v4_metrics.jsonl")
# learned VO from pixels, the official recipe (README, .claude/skills/verify/
# SKILL.md): vo_windows_transformer_v6_verified (embed 384, 8 layers, 8
# heads; 8 restarts of the curriculum eval solver in each bootstrap window:
# K1 and K2 at B = 8), frontend_v4 at 96 px with the verification gates
# (K3 at 15 problems on the whole sequence, 3 on a window, each twice with
# the cycle gate), 16 frames of 8 points, 3 bootstraps, ba_irls 2, no
# refinement; trial 0 only (JAX's key 100: a generator seeded 100)
V6_CHECKPOINT = os.path.join(REPO, "artifacts", "vo_windows_transformer_v6_verified.pkl")
FRONTEND_NPZ = os.path.join(REPO, "davo_tpu_torch", "weights", "frontend_v4.npz")
V6_WIDTH = ["--hidden-size", "384", "--transformer-layers", "8", "--transformer-heads", "8"]
VO_EVAL_ARGS = [
    "vo-eval", "--checkpoint", V6_CHECKPOINT, *V6_WIDTH,
    "--pipeline", "incremental", "--association", "geometric", "--no-refine", "--matches", "learned",
    "--frontend-checkpoint", FRONTEND_NPZ,
    "--nms-radius", "0.1", "--snap-radius", "0.12", "--cycle-threshold", "0.15", "--quality-bonus", "10.0",
    "--score-threshold", "0.2", "--centroid-refine", "2", "--ba-irls", "2", "--trials", "1",
]
VO_EVAL_REFERENCE_LOG = os.path.join(REPO, "artifacts", "eval_learned_v7_final.log")
VO_BATCH = 8  # one window x 8 restarts: K1 and K2's batch in a bootstrap solve
VO_K3_PROBLEMS = (15, 3)  # the whole sequence's 15 anchor-to-view problems; a window's 3
# the accumulator on fixed clean inputs (the JAX test
# test_detection_pipeline_robust_options): 10 frames of 8 points, oracle
# detections among 12 a frame (junk elsewhere), a truth bootstrap of two
# frames, every robustness option; the card in float32 against the CPU in
# float64 (CPU float32 against float64 read 3e-7 and 6e-5 on two seeds)
VO_CLEAN_ROTATION_TOL, VO_CLEAN_TRANSLATION_TOL, VO_CLEAN_ATE_TOL = 1e-4, 1e-3, 5e-3
# windowed VO, the JAX CLI's vo-eval default (windows, oracle matches,
# global stitch, refinement) at v6_verified's width (v3_1200, the logs'
# checkpoint, has its architecture but does not fit the copy's cap beside
# the earlier phases' pickles), trial 0: the 7 windows of 16 frames x 8
# restarts solved in one stacked call (K1 and K2 at B = 56, P = 45); then,
# from the same window solves, chain, global and robust stitching,
# multistart 4 with the float64 polish (the card's against the CPU's), and
# correct_scale_drift (K1 at P = 15, B = 1); the oracle-guess recovery
# check; learned matches (frontend_v4, the official gates: K3 at 21
# problems)
VO_WINDOWS_ARGS = ["vo-eval", "--checkpoint", V6_CHECKPOINT, *V6_WIDTH, "--trials", "1"]
VO_WINDOWS_LEARNED_ARGS = VO_WINDOWS_ARGS + [
    "--matches", "learned", "--frontend-checkpoint", FRONTEND_NPZ, "--nms-radius", "0.1", "--snap-radius", "0.12",
    "--cycle-threshold", "0.15", "--quality-bonus", "10.0", "--score-threshold", "0.2", "--centroid-refine", "2",
]
VO_WINDOWS_LOGS = {name: os.path.join(REPO, "artifacts", f"{name}.log")
                   for name in ("eval_v3_vo", "eval_v3_vo_raw", "eval_stitch_compare", "eval_learned_v3")}
VO_WINDOWS = 7  # windows of 4 at stride 2 over 16 frames
VO_WINDOWS_BATCH = VO_WINDOWS * 8  # the stacked window solve's batch: K1 and K2
VO_DRIFT_P, VO_DRIFT_BATCH = 15, 1  # correct_scale_drift's BFGS over 16 frames' segments
VO_MULTISTART = 4
VO_RECOVERY_ATE = 1e-4  # tests/train/test_vo_eval.py's bound on oracle-guess windows
VO_POLISH_TOL = 1e-9  # the float64 polish, card against CPU, normwise on the poses
# eval-seq on the fixtures: compare mode (TUM), oracle VO and learned VO
# (v6_verified at 8 points, windows of 4, the front end with eval-seq's
# gates) along the KITTI file; the learned case's 8 restarts cut to 1 (at
# 8 its 100 line searches run into their 50-probe cap: 101.6 s of host
# work, where a host 1.25 times slower would put the run past its limit)
FIXTURES = os.path.join(REPO, "tests", "fixtures")
EVAL_SEQ_CASES = {
    "compare": ["eval-seq", "--gt", os.path.join(FIXTURES, "tum_mini_groundtruth.txt"), "--est",
                os.path.join(FIXTURES, "tum_mini_estimated.txt")],
    "oracle": ["eval-seq", "--gt", os.path.join(FIXTURES, "kitti_mini_00.txt"), "--format", "kitti"],
    "learned": ["eval-seq", "--gt", os.path.join(FIXTURES, "kitti_mini_00.txt"), "--format", "kitti", "--checkpoint",
                V6_CHECKPOINT, *V6_WIDTH, "--points", "8", "--window", "4", "--restarts", "1", "--frontend-checkpoint",
                FRONTEND_NPZ],
}
# eval-seq's learned VO at the CLI's default --points 32 (and --window 4):
# every checkpoint in the repo is of 8 points (frontend_v4 selects 8; with
# it the JAX CLI raises at 32 points too), so the guess network is
# v6_verified's architecture at 4 x 32 (P = 117) with random weights from a
# seed, pickled as the JAX package's numpy checkpoint, and the front end
# frontend_v4's architecture at 32 points after one fit-frontend step from
# a flax-style init (96 px, batch 2); K1 at P = 117, K2 at (4, 32) and K3
# on the 12-frame KITTI file's 5 windows (1 restart each)
EVAL_SEQ_POINTS, EVAL_SEQ_WINDOWS, EVAL_SEQ_P = 32, 5, 3 + 3 * 32 + 6 * (M - 1)
EVAL_SEQ_32_ARGS = ["eval-seq", "--gt", os.path.join(FIXTURES, "kitti_mini_00.txt"), "--format", "kitti", *V6_WIDTH,
                    "--restarts", "1"]
EVAL_SEQ_FRONTEND_ARGS = ["fit-frontend", "--epochs", "1", "--batch-size", "2", "--batches-per-epoch", "1",
                          "--image-size", "96", "--points", str(EVAL_SEQ_POINTS)]
# scene sizes the kernels take by their general path: eval-seq's (4, 32) at
# its batch and at the serve batch, 3 views, 96 terms in three chunks
GENERAL_SCENES = ((4, 32), (3, 8), (6, 16))
# the multi-device layer on a one-rank NCCL group (the machine has one
# card): tests/parallel/test_schur.py's problem (4 views, 16 points), 8 LM
# iterations, float64; an 8-frame stitch; one data-parallel step of the
# MLP head in float32 at batch 64; the card's solves against the
# single-device solver to 1e-12, the stitch against the same function on
# a gloo group on the CPU to 1e-12, the step against make_train_step to 1e-6
MULTIDEVICE_SOLVE_TOL, MULTIDEVICE_STEP_TOL = 1e-12, 1e-6
# the learned solvers: artifacts/learned_solver_descent_v2.pkl (the
# recurrent MLP solver, hidden 256, 5 steps, trained with the descent loss)
# against BFGS at 5 and 20 iterations (16 probes a line search) on 2
# batches of 256 scenes: K1 at B = 256, P = 45; each row's objective and
# the BFGS rows' basin rates within the band around
# learned_solver_descent3.log's table (that checkpoint's TPU run, other
# draws); then the logged epoch 0 (64 batches of 256, each run's config as
# its log's run line records it) of each solver type from a flax-style init
# beside the JAX runs' epoch 0 (the final error of each asserted in the
# band; the focal error is heavy-tailed and only reported); then the
# trained direction gate's comparison (K1 with direction_fn)
LEARNED_SOLVER_CHECKPOINT = os.path.join(REPO, "artifacts", "learned_solver_descent_v2.pkl")
LEARNED_SOLVER_LOG = "learned_solver_descent3.log"
LEARNED_SOLVER_BATCHES, LEARNED_SOLVER_DIRECTION_BATCHES = 2, 1
# the logged runs' epoch: 64 batches of 256 (their learning rate is
# constant, so epoch 0 of their 20 is this one epoch)
LEARNED_SOLVER_TRAIN = dict(epochs=1, batches_per_epoch=64, batch_size=256)
LEARNED_SOLVER_RUNS = {  # solver type: (loss mode, the JAX run's metrics)
    "mlp": ("descent", "learned_solver_descent3_metrics.jsonl"),
    "transformer": ("descent", "learned_solver_transformer_r4.jsonl"),
    "direction": ("final", "learned_solver_direction_metrics.jsonl"),
}
LEARNED_SOLVER_BAND = (0.6, 1.5)  # times the JAX figure
# the gen-1 stack: one bfgs_solver_only_error_gradient train step on the
# card against the CPU (a fixed batch of 16, relative error of the loss
# and metrics, normwise of the gradients; asserted in float64, as
# train_check, and reported in float32, where rounding flips the unrolled
# solve's line-search decisions: 1.2e-5 to 1.9e-3 on the loss and 3.6e-2
# to 9.3e-2 on the gradients, card against CPU, on an H100), then each preset's
# steps at its own batch (the two unrolled-BFGS presets at 64, mlp_guess at
# 256 with hidden 2,048), then the protocol solver (bfgs_solve_function)
# on 64 PinholeCameraModelL1 objectives of 4 views x 8 points: K1 at P =
# 3 + 6 M + 3 N - 7 = 44, the card against the CPU
GEN1_CHECK_BATCH, GEN1_CHECK_TOL = 16, 1e-8
GEN1_STEPS = {"bfgs_solver_full_gradient": 4, "bfgs_solver_only_error_gradient": 4, "mlp_guess": 12}
GEN1_P, GEN1_SOLVE_SCENES = 3 + 6 * M + 3 * N - 7, 64
# the distortion pipeline: cli eval-distorted at its defaults (4 batches of
# 16 scenes, 32 points, perturbation 0.02, 60 LM iterations) and
# refine_distorted at the JAX bench's size (scripts/distorted_bench.py:
# 4,096 scenes, float32, 60 iterations) on a CPU generator's draws, whose
# figures must fall in bands written from a CPU run of the same draws
# (before the first chip call); the card against the CPU in float64 on 16
# scenes; the closed-form Jacobian against jacfwd in float32
DISTORTED_BATCH, DISTORTED_ITERATIONS, DISTORTED_SEED = 4096, 60, 0
DISTORTED_CHECK_SCENES, DISTORTED_CHECK_TOL, DISTORTED_JACOBIAN_TOL = 16, 1e-9, 1e-5
DISTORTED_LOG = os.path.join(REPO, "artifacts", "distorted_bench_r5b.log")
# a CPU run of the same draws in float32 read mean_param_error 1.1287e-6
# and rms_residual 3.751e-8 (max 3.63e-4): the card's rounding may move
# each by up to 2 times
DISTORTED_BANDS = {"mean_param_error": (5.6e-7, 2.3e-6), "rms_residual": (1.9e-8, 7.5e-8)}
# sequential tracking: the vo_eval phase's 16-frame orbits of 8 points
# (vo-eval's trials 0-3) through frontend_v4 with its gates at 96 px; K3
# at TRACK_SEQUENCES problems of N = 8 track queries against 144 cells,
# once a frame after the first
TRACK_SEQUENCES, TRACK_FRAMES = 4, 16
TRACK_GATES = dict(nms_radius=0.1, snap_radius=0.12, cycle_threshold=0.15, quality_bonus=10.0, score_threshold=0.2,
                   centroid_refine_iters=2)
# the run infrastructure: fit --config of a configurations/ YAML (PyYAML)
# cut to 1 epoch of 2 batches, its metrics mirrored to TensorBoard (the
# tensorboard package; the card's machine has both), its run in a
# temporary registry; the JAX CLI's presets (davo_tpu/train/presets.py:
# 85-91, sorted as it prints them)
INFRA_CONFIG = os.path.join(REPO, "configurations", "mlp_guess_config.yaml")
JAX_PRESETS = ["bfgs_solver_full_gradient", "bfgs_solver_only_error_gradient", "calibration_from_oracle_matches",
               "calibration_transformer_curriculum", "mlp_guess"]
# the Orbax reader: the JAX package's stores read on the card's host (no
# zstd, tensorstore or Orbax there), v4 against the .npz and v5_tokens/1800
# against the pickle's digest bit for bit; then served on the card: frontend_v2 (8
# points, 64 px) in one learned-match window request of frontend_serve's
# kind (1,024 windows, the window solver vo_windows_transformer_v2_600:
# K3, then K1 and K2 at B = 8,192), one validation batch of frontend_v3's
# fit-frontend recipe (16 windows of 16 points, 64 px: K3), and cli eval
# at v5_tokens through --checkpoint-dir artifacts/ckpt_v5_tokens (embed 384,
# 8 layers, 8 readout tokens as scripts/recipe_eval_v5.py; its 8 tokens as
# the restarts, one eval and one ATE batch of 64 scenes: K1 and K2 at B =
# 512); each figure beside the JAX log's (torch draws: within a band)
# (of time_orbax_reads.STORES: v5_tokens_600 is left out of the GPU
# machine's copy of the repo, capped at 256 MiB; see .chiprunignore)
ORBAX_STORES = ("frontend_v2", "frontend_v3", "frontend_v4", "v5_tokens_1800")
ORBAX_V3_POINTS, ORBAX_V3_BATCH = 16, 16
ORBAX_CELLS = 64  # the detector's 8 x 8 cells of a 64-px image: K3's queries and keys
ORBAX_INLIER_REFERENCE = {  # the JAX runs' final validation (8 batches of 16 windows)
    "frontend_v2": (0.895263671875, "artifacts/train_frontend_v2.log"),
    "frontend_v3": (0.8419027328491211, "artifacts/train_frontend_v3_dense.log"),
}
ORBAX_INLIER_BAND = {"frontend_v2": (0.9, 1.1), "frontend_v3": (0.85, 1.15)}  # times the JAX figure
V5_EVAL_BATCH = 64
V5_EVAL_ARGS = [
    "eval", "--preset", "calibration_transformer_curriculum", "--hidden-size", "384", "--transformer-layers", "8",
    "--transformer-heads", "8", "--guess-tokens", "8", "--restart-proposals", "tokens", "--restarts", "8",
    "--batch-size", str(V5_EVAL_BATCH), "--batches", "1", "--ate-batches", "1",
    "--checkpoint-dir", V5_CHECKPOINT,
]
# the Orbax writer: every ORBAX_STORES store read, written twice (the faster
# write timed) and read back on the card's host, one SHA-256 tree digest
# each side; cli fit at the train phase's reference recipe at full width
# (calibration_from_oracle_matches: MLP hidden 256, batch 64, the
# 10-iteration unrolled solve), cut by a --config file to 2 epochs of 2
# batches and 1 validation batch (its solve cut as resume_check's), into
# Orbax directories: 2 epochs whole by cli fit, and 1 epoch by fit then 1 by
# cli fit resuming, the resumed epoch against the whole run's second to
# RESUME_TOL; cli eval from the whole run's directory (one eval and one ATE
# batch of 64 scenes: K1 and K2 at B = 64, P = 45); fit-frontend at
# frontend_v4's recipe (96 px) cut to one epoch of 2 steps into an Orbax
# directory, read back by load_frontend (its weights and its matches on one
# request's images bit for bit those of the trained module still in
# memory) and served in one learned-match window request of 1,024 windows
# (K3, then K1 and K2 at B = 8,192; two steps from a random init: no band)
ORBAX_WRITE_CONFIG = {"preset": "calibration_from_oracle_matches", "epochs": 2, "batches_per_epoch": 2,
                      "val_batches": 1, "solver": {"iterations": RESUME_EVAL_ITERATIONS}}
ORBAX_WRITE_EVAL_ARGS = ["eval", "--preset", "calibration_from_oracle_matches", "--batch-size", "64", "--batches",
                         "1", "--ate-batches", "1"]
ORBAX_WRITE_FRONTEND_ARGS = ["fit-frontend", "--image-size", str(FRONTEND_IMAGE_SIZE), "--epochs", "1",
                             "--batches-per-epoch", "2"]
# the v2 calibration curriculum's curve (artifacts/runs/calib_v2_metrics.jsonl,
# which records no config: scripts/train_guess_v3.py names the v2 recipe,
# the calibration_transformer_curriculum preset at embed 256, 6 layers, 600
# epochs, with the FOV curriculum; calibration_transformer_v2_600.pkl has
# 8 heads) through fit_fov_curriculum at that run's schedule (600 epochs
# of 128 batches of 64: warm-up 500, cosine over 76,800 steps), stopped
# after CURRICULUM_EPOCHS epochs of its first stage (50-80 degrees), its
# validation cut from 16 batches to CURRICULUM_VAL_BATCHES (a batch is a
# 100-iteration eval solve, 12-13 s: K1 and K2 at B = 64); each epoch's
# train loss within CURRICULUM_BAND times the log's (a mean of 128 steps),
# the validation loss (one batch, heavy-tailed) reported
CURRICULUM_EPOCHS, CURRICULUM_VAL_BATCHES = 6, 1
CURRICULUM_RUN = dict(epochs=600, hidden_size=256, transformer_layers=6, transformer_heads=8)
CURRICULUM_FIRST_STAGE = (50.0, 80.0)
CURRICULUM_BAND = (0.75, 1.33)  # times the JAX figure: 0.906-1.006 read on an H100
CURRICULUM_REFERENCE_LOG = os.path.join(REPO, "artifacts", "runs", "calib_v2_metrics.jsonl")
# the phases run beside eval_v4 ... frontend_train (which time no kernel),
# each group one after another in a process of its own, the two processes
# side by side: in one process they outlasted those phases (620 s against
# ~560 on an H100's host) and the run took 1,108 s of its 1,200
SIDE_PROCESSES = (("vo_eval", "vo_windows", "eval_seq"),
                  ("orbax", "orbax_write", "calib_curriculum", "learned_solver"))
SIDE_PHASES = tuple(name for group in SIDE_PROCESSES for name in group)
# the paths whose launch counts the kernels line reports
LAUNCH_PATHS = ("frontend_serve", "fused_objective", "k1_tune", "eval_v4", "eval_lbfgs", "frontend_train", "vo_eval",
                "vo_windows", "vo_windows_scale_drift", "vo_windows_learned", "eval_seq_learned", "eval_seq_learned_32",
                "learned_solver", "learned_solver_direction", "gen1_protocol_solve", "track_sequence",
                "orbax_frontend_v2", "orbax_frontend_v3", "orbax_v5_eval", "orbax_write_eval",
                "orbax_write_frontend", "calib_curriculum")


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


def k1_symbol(h_dtype, variant_symbol=None, p=3 + 3 * N + 6 * (M - 1)):
    """The mangled-name fragment of the kernel a K1 phase times at an even
    batch: K1's register route (P <= 48: one float32 element or a bfloat16
    pair a thread) or its two-pass route (P > 48), or K1''s kernel in the
    ordering ``variant_symbol`` (16 elements a block: one element a
    thread)."""
    type_code = "13__nv_bfloat16" if h_dtype == torch.bfloat16 else "f"
    if variant_symbol:
        return f"{variant_symbol}{type_code}Li1E"
    if p > 48:
        return f"bfgs_update_two_pass_kernelI{type_code}E"
    return f"bfgs_update_rows_kernelI{type_code}Li{2 if h_dtype == torch.bfloat16 else 1}E"


def k1_phase(batch, h_dtype, device, variant=None, p=3 + 3 * N + 6 * (M - 1)):
    """K1, or with ``variant = (kernel, plain, symbol)`` one of the K1'
    orderings, against its plain version and timed.  K1 is checked on a
    symmetric carry (it takes y'H = (Hy)' by symmetry); K1' on that carry
    and on one that is not symmetric (H + 0.05 N), since it reduces y'H
    over the rows as the TPU kernels do."""
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.ops.bfgs_update import fused_bfgs_update_direction, reference_update_direction

    kernel, plain_version, symbol = variant or (fused_bfgs_update_direction, reference_update_direction, None)
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
        batch=batch, p=p, h_dtype=str(h_dtype).replace("torch.", ""), checks=checks, max_abs_err=worst,
        ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / ms, GBps=bytes_moved / ms / 1e6, library_ms=None,
        ptxas=ptxas_resources(build.build_log.get("ptxas", []), k1_symbol(h_dtype, symbol, p)),
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


def k2_inputs(batch, device, seed, m=M, n=N):
    from davo_tpu_torch.data import SceneConfig, generate_batch

    g = torch.Generator(device).manual_seed(seed)
    scenes = generate_batch(g, batch, SceneConfig(num_views=m, num_points=n), device=device)
    p = 3 + 3 * n + 6 * (m - 1)
    params = 0.3 * torch.randn(batch, p, generator=g, device=device)
    params[:, 0] += 1.0
    params[:, 5 : 3 + 3 * n : 3] += 1.0
    r0 = 3 + 3 * n + 3 * (m - 1)
    params[: batch // 8, r0:] *= 1e-3  # small angles: the Taylor branches
    params[batch // 8 : batch // 4, 0] -= 2.0  # negative focal: the exp branch
    vis = scenes.visibility_mask.float()
    u = scenes.projected_points[..., 0].permute(1, 2, 0).contiguous()
    v = scenes.projected_points[..., 1].permute(1, 2, 0).contiguous()
    return params.contiguous(), u, v, vis.permute(1, 2, 0).contiguous()


def k2_symbol(kernel, m, n):
    """The mangled-name fragment of K2's or K4's kernel at (m, n): the
    (4, 8) instantiation, or the general kernel every other size takes."""
    return f"{kernel}ILi{m}ELi{n}E" if (m, n) == (M, N) else f"{kernel[:-len('kernel')]}general_kernel"


def k2_phase(batch, device, m=M, n=N):
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.ops.calibration_obj import _value_and_grad_plain, calibration_value_and_grad

    params, u, v, vis = k2_inputs(batch, device, seed=batch + 1, m=m, n=n)
    k_err, k_grad = calibration_value_and_grad(params, u, v, vis)
    torch.cuda.synchronize()
    p_err, p_grad = _value_and_grad_plain(params, u, v, vis)
    # float32 sums of M N angles / gradient terms in another order
    checks = {"error": check("K2 error", k_err, p_err, 1e-5), "gradient": check("K2 gradient", k_grad, p_grad, 1e-4)}
    # the inputs (6 MB at B = 8192) stay in the L2 across the repeats: warm
    ms = cuda_ms(lambda: calibration_value_and_grad(params, u, v, vis), reps=100)
    graph_ms = graph_replay_ms(lambda: calibration_value_and_grad(params, u, v, vis), reps=100)
    plain_ms = cuda_ms(lambda: _value_and_grad_plain(params, u, v, vis), reps=10, warmup=1)
    p = params.shape[1]
    bytes_moved = batch * 4 * (p + 3 * m * n + 1 + p)
    operations = batch * k2_operations(m, n)
    bound_ms, bound_by = bound(bytes_moved, operations)
    return dict(
        batch=batch, scene=[m, n], p=p, checks=checks,
        max_abs_err=max(checks["error"]["max_abs_err"], checks["gradient"]["max_abs_err"]),
        ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / ms, library_ms=None, operations_per_element=k2_operations(m, n),
        ptxas=ptxas_resources(build.build_log.get("ptxas", []), k2_symbol("calibration_vg_kernel", m, n)),
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


def k4_phase(batch, device, m=M, n=N):
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.ops.calibration_obj import _value_and_dirderiv_plain, calibration_value_and_dirderiv

    params, u, v, vis = k2_inputs(batch, device, seed=batch + 2, m=m, n=n)  # small angles, f <= 0 on 1/8
    p = params.shape[1]
    direction = torch.randn(batch, p, generator=torch.Generator(device).manual_seed(batch + 3), device=device)
    vis[:, :, 0] = 0.0  # element 0 sees nothing
    params[1, 0] = 0.0  # element 1: f = 0 exactly, the exp branch's edge
    args = (params, direction, u, v, vis)
    k_err, k_dphi = calibration_value_and_dirderiv(*args)
    torch.cuda.synchronize()
    p_err, p_dphi = _value_and_dirderiv_plain(*args)
    # float32 sums of M N angles (and of their tangents) in another order
    checks = {"error": check("K4 error", k_err, p_err, 1e-5), "dphi": check("K4 dphi", k_dphi, p_dphi, 1e-4)}
    if not (k_err[0].item() == 0.0 and k_dphi[0].item() == 0.0):
        raise AssertionError(f"K4: an element that sees nothing gave {k_err[0].item()}, {k_dphi[0].item()}")
    ms = cuda_ms(lambda: calibration_value_and_dirderiv(*args), reps=100)
    graph_ms = graph_replay_ms(lambda: calibration_value_and_dirderiv(*args), reps=100)
    plain_ms = cuda_ms(lambda: _value_and_dirderiv_plain(*args), reps=10, warmup=1)
    # each element reads its parameters, direction and M N observations
    # (u, v, vis) once and writes its error and dphi
    bytes_moved = batch * 4 * (2 * p + 3 * m * n + 2)
    operations = batch * k4_operations(m, n)
    bound_ms, bound_by = bound(bytes_moved, operations)
    return dict(
        batch=batch, scene=[m, n], p=p, checks=checks,
        max_abs_err=max(checks["error"]["max_abs_err"], checks["dphi"]["max_abs_err"]),
        ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
        library_ms=None, operations_per_element=k4_operations(m, n),
        ptxas=ptxas_resources(build.build_log.get("ptxas", []), k2_symbol("calibration_dirderiv_kernel", m, n)),
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


def k3_bound(b, ql, kl, d, c):
    """K3's least time at ``b`` problems of ``ql`` queries against ``kl``
    keys: the bytes (each input read once, the output written once), or
    the kernel's route, QK^T as three TF32 products on the tensor cores
    (3xTF32), PV and one exp a score on the CUDA cores; with its parts."""
    t_bytes = 4 * b * (ql * d + kl * d + kl * c + ql * c) / PEAK_BYTES_PER_S * 1e3
    t_tensor = 3 * b * 2 * ql * kl * d / PEAK_TF32_OPS_PER_S * 1e3
    t_cuda = b * (2 * ql * kl * c + ql * kl) / PEAK_F32_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_tensor, t_cuda)
    return bound_ms, "bytes" if bound_ms == t_bytes else "operations", (t_bytes, t_tensor, t_cuda)


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
        # vo-eval's calls: the whole sequence (16 frames), a window (4), the
        # windows pipeline's stacked windows
        *((f"vo_{b}", b, K3_CELLS, K3_CELLS, K3_DEPTH, K3_WIDTH, False)
          for b in VO_K3_PROBLEMS + ((M - 1) * VO_WINDOWS,)),
        # the orbax phase's 64-px front ends: frontend_v2's request, frontend_v3's batch
        ("orbax_v2", (M - 1) * WINDOWS, ORBAX_CELLS, ORBAX_CELLS, K3_DEPTH, K3_WIDTH, False),
        ("orbax_v3", (M - 1) * ORBAX_V3_BATCH, ORBAX_CELLS, ORBAX_CELLS, K3_DEPTH, K3_WIDTH, False),
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
    bound_ms, bound_by, (t_bytes, t_tensor, t_cuda) = k3_bound(b, ql, kl, d, c)
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
    """Request 0's first COMPARISON_WINDOWS windows solved three ways (the
    same solver): on the top-k learned matches (taken from the request), on vo-eval's
    default front end (greedy NMS, radius 0.1; every other gate off) and
    on the oracle matches, the last two in one solve with each its own
    restart draws (each element is solved on its own: in float64 the one
    solve gives the bits of two; in float32 the head's products may round
    otherwise at another batch).  The NMS front end's match_inlier_rate
    covers all 1,024 windows."""
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
    draw_shape = (COMPARISON_WINDOWS, network.num_restarts - 1, params.shape[-1])
    draws = [torch.randn(draw_shape, generator=torch.Generator(device).manual_seed(seed), device=device)
             for seed in (4000, 3000)]
    both_params, both_error = network(
        torch.cat([nms_out.matches[sub], sub_windows.projected_points]),
        torch.cat([nms_out.match_visibility[sub].to(sub_windows.visibility_mask.dtype), sub_windows.visibility_mask]),
        restart_draws=torch.cat(draws), return_error=True,
    )
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    (nms_params, oracle_params), (nms_error, oracle_error) = both_params.chunk(2), both_error.chunk(2)
    for label, p in (("nms", nms_params), ("oracle", oracle_params)):
        if not torch.isfinite(p).all():
            raise AssertionError(f"subset comparison: the {label} solve gave non-finite values")
    comparison = dict(
        windows=COMPARISON_WINDOWS, nms_gates=VO_EVAL_GATES,
        nms_match_inlier_rate=frontend_eval_metrics(nms_out, windows, experiment)["match_inlier_rate"].item(),
        nms_visible_match_share=nms_out.match_visibility.float().mean().item(),
        nms_frontend_s=t1 - t0, nms_and_oracle_solve_s=t2 - t1,
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
    architecture (read from its arrays), its weights read as the eval
    entry reads a checkpoint directory: ``checkpoint`` itself where it is
    one (an Orbax directory), else one that links the pickle."""
    import dataclasses

    from davo_tpu_torch.models import checkpoint_architecture, load_flax_weights
    from davo_tpu_torch.train import get_preset, restore_checkpoint

    if os.path.isdir(checkpoint):
        restored = restore_checkpoint(checkpoint)
    else:
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
    """Two train steps on the card and two on the CPU, float64, from the
    same flax-style weights, the same batch and the same keep-masks (drawn
    once on the CPU): the MLP head (hidden 32) through a 3-iteration
    unrolled solve with drop-path 0.1, batch 16, with a one-step warm-up,
    so that the first update's rate is 0 and the second's is the peak.
    Each step's loss and metrics agree to TRAIN_CHECK_TOL relative to
    themselves; the parameters, their update over the two steps, AdamW's
    two moments and the running statistics each agree to TRAIN_CHECK_TOL
    normwise over the network, in the 2-norm; neither kernel runs (the
    training solve is unfused, as in the JAX package)."""
    from davo_tpu_torch.data import SceneConfig, generate_batch
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.solve import BFGSConfig
    from davo_tpu_torch.train import create_train_state, make_train_step

    batch_size, iterations, steps = 16, 3, 2
    batch = generate_batch(torch.Generator("cpu").manual_seed(5), batch_size,
                           SceneConfig(num_views=M, num_points=N, dtype=torch.float64), device="cpu")
    keep_masks = torch.rand(steps, iterations, batch_size, generator=torch.Generator("cpu").manual_seed(6)) > 0.1
    config = fixed_batch_experiment(
        batch, num_views=M, num_points=N, hidden_size=32, batch_size=batch_size, dtype=torch.float64,
        warmup_steps=1,
        solver=BFGSConfig(error_threshold=1e-7, training_error_threshold=1e-3, iterations=100,
                          training_iterations=iterations, line_search_iterations=50, drop_path_p=0.1),
    )
    out = []
    for dev in (device, torch.device("cpu")):
        state = create_train_state(config, dev)
        initial = {k: p.detach().cpu().clone() for k, p in state.network.named_parameters()}
        train_step = make_train_step(state, config)
        build.reset_launch_counts()
        metrics = [train_step(torch.Generator(dev).manual_seed(i), keep_masks=keep_masks[i]) for i in range(steps)]
        launches = dict(build.launch_counts)
        if any(launches.values()):
            raise AssertionError(f"train_check: the train steps launched kernels {launches}")
        tensors = {}
        for k, v in state.network.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                tensors["running_statistics" if "running_" in k else "parameters", k] = v.detach().cpu()
        for k, p in state.network.named_parameters():
            adam = state.optimizer.state[p]
            tensors["updates", k] = p.detach().cpu() - initial[k]
            tensors["first_moments", k] = adam["exp_avg"].cpu()
            tensors["second_moments", k] = adam["exp_avg_sq"].cpu()
        out.append(([{k: float(v) for k, v in m.items()} for m in metrics], tensors))
    (metrics, tensors), (cpu_metrics, cpu_tensors) = out
    checks = [{name: relative_error(metrics[i][name], value) for name, value in step.items()}
              for i, step in enumerate(cpu_metrics)]
    squares = {}
    for (kind, name), value in cpu_tensors.items():
        err, ref = squares.get(kind, (0.0, 0.0))
        diff = tensors[kind, name].double() - value.double()
        squares[kind] = (err + float(torch.sum(diff * diff)), ref + float(torch.sum(value.double() ** 2)))
    normwise = {kind: math.sqrt(err / ref) for kind, (err, ref) in squares.items()}
    failed = [(f"step {i} {name}", e) for i, step in enumerate(checks) for name, e in step.items()]
    failed = [(name, e) for name, e in failed + list(normwise.items()) if not e <= TRAIN_CHECK_TOL]
    if failed:
        raise AssertionError(f"train_check: beyond {TRAIN_CHECK_TOL}: {failed}")
    update_norm = math.sqrt(squares["updates"][1])
    if not update_norm > 0:
        raise AssertionError("train_check: the second update moved no parameter")
    return dict(batch=batch_size, training_iterations=iterations, steps=steps, warmup_steps=config.warmup_steps,
                dtype="float64", tolerance=TRAIN_CHECK_TOL, metrics=checks, normwise=normwise,
                update_norm_cpu=update_norm, loss_card=[m["loss"] for m in metrics],
                loss_cpu=[m["loss"] for m in cpu_metrics])


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
    checkpoint, 8 restarts, 64 scenes for the ATE, counted from 0 just
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


def logged_run_config(path):
    """The config a JAX training run recorded in its metrics file's first
    line (``{"run": {"config": ...}}``)."""
    with open(path) as f:
        return json.loads(f.readline())["run"]["config"]


def config_differences(config, logged, skip=()):
    """``{field: (ours, logged)}`` for each field of a JAX run's recorded
    config that ``config`` (a dataclass) sets otherwise: nested configs
    field by field, dtypes by name; ``skip`` names top-level fields left
    out, each for a reason its caller gives."""
    import dataclasses

    out = {}
    for key, want in logged.items():
        if key in skip:
            continue
        got = getattr(config, key, "<missing>")
        if dataclasses.is_dataclass(got) and isinstance(want, dict):
            out.update({f"{key}.{k}": v for k, v in config_differences(got, want).items()})
        elif key == "dtype":
            if str(got).rsplit(".", 1)[-1] != str(want).rsplit(".", 1)[-1].rstrip("'>"):
                out[key] = (str(got), want)
        elif isinstance(want, float) and isinstance(got, (int, float)):
            if not math.isclose(float(got), want, rel_tol=1e-12):
                out[key] = (got, want)
        elif got != want:
            out[key] = (got, want)
    return out


def frontend_logged_config():
    """The port's FrontendExperiment for frontend_v4's logged run, checked
    field by field against its recorded config (600 epochs)."""
    import dataclasses

    from davo_tpu_torch.data import RenderConfig
    from davo_tpu_torch.train import FrontendExperiment

    logged = logged_run_config(FRONTEND_REFERENCE_LOG)
    config = dataclasses.replace(FrontendExperiment(), epochs=logged["epochs"],
                                 render=RenderConfig(image_size=FRONTEND_IMAGE_SIZE))
    differences = config_differences(config, logged)
    if differences:
        raise AssertionError(f"frontend_train: the config differs from the logged run's: {differences}")
    return config


def frontend_epochs(config, device, epochs, log_fn):
    """fit_frontend's loop (its key paths, its per-epoch means) over the
    first ``epochs`` of ``config.epochs``: a fresh create_frontend_state
    whose schedule spans the whole run; ``log_fn(split, epoch, metrics)``
    after each split.  Returns the state."""
    from davo_tpu_torch.train import batch_generator, create_frontend_state, make_frontend_train_step

    state = create_frontend_state(config, device)
    train_step, eval_step = make_frontend_train_step(state, config)
    for epoch in range(epochs):
        start = time.time()
        steps = [train_step(batch_generator(device, config.seed, epoch, 0, i)) for i in range(config.batches_per_epoch)]
        train = {k: float(torch.stack([m[k] for m in steps]).mean()) for k in steps[0]}
        train["epoch_seconds"] = time.time() - start
        log_fn("train", epoch, train)
        val = [eval_step(batch_generator(device, config.seed, epoch, 1, j)) for j in range(config.val_batches)]
        log_fn("val", epoch, {k: float(torch.stack([m[k] for m in val]).mean()) for k in val[0]})
    return state


def frontend_train_phase(device):
    """The frontend_v4 recipe at full width from a flax-style init: the
    logged run's config (600 epochs: its schedule) stopped after
    FRONTEND_EPOCHS epochs (fit_frontend's loop, frontend_epochs), its
    launches read per split (counted from 0 just before the run, read and
    reset at each split's log); then the same for FRONTEND_SPREAD_SEEDS
    (the port's spread); then, outside the counted run, each train step
    timed alone, a profiler window over PROFILED_STEPS steps, and the
    checkpoint round trip (saved as fit-frontend saves it, read by
    load_frontend, its eval forward equal to the trained module's)."""
    import dataclasses

    from davo_tpu_torch.data import VOWindowConfig, generate_vo_window_batch
    from davo_tpu_torch.models import load_frontend
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import (
        batch_generator,
        make_frontend_train_step,
        render_scene_batch,
        save_frontend_checkpoint,
    )

    config = frontend_logged_config()
    reference = frontend_reference_curve()
    launches = {"train": [], "val": []}
    epochs, train_rows = [], []

    def log_fn(split, epoch, metrics):
        launches[split].append(build.launch_counts["match_attention"])
        build.reset_launch_counts()
        if split == "train":
            train_rows.append(metrics)
            return
        epochs.append(dict(
            epoch=epoch, train_loss=train_rows[-1]["loss"], val_loss=metrics["loss"],
            match_inlier_rate=metrics["match_inlier_rate"], epoch_seconds=train_rows[-1]["epoch_seconds"],
            jax=reference.get(epoch),
        ))
        print(json.dumps({"frontend_train_epoch": epochs[-1]}), flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    start = time.perf_counter()
    state = frontend_epochs(config, device, FRONTEND_EPOCHS, log_fn)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() / 1e9
    if any(launches["train"]):
        raise AssertionError(f"frontend_train: the train steps launched K3 {launches['train']}")
    if not all(n > 0 for n in launches["val"]):
        raise AssertionError(f"frontend_train: a validation never launched K3 {launches['val']}")

    # the port's spread: the same run from other seeds (validation only);
    # every seed's every epoch within FRONTEND_BANDS of the JAX log's
    spread = {0: [dict(val_loss=e["val_loss"], match_inlier_rate=e["match_inlier_rate"]) for e in epochs]}
    for seed in FRONTEND_SPREAD_SEEDS:
        rows = spread.setdefault(seed, [])
        frontend_epochs(dataclasses.replace(config, seed=seed), device, FRONTEND_EPOCHS,
                        lambda split, epoch, m, rows=rows: split == "val" and rows.append(
                            dict(val_loss=m["loss"], match_inlier_rate=m["match_inlier_rate"])))
    spread_rows = [dict(epoch=e, jax=reference[e], **{k: [spread[s][e][k] for s in spread] for k in FRONTEND_BANDS})
                   for e in range(FRONTEND_EPOCHS)]
    print(json.dumps({"frontend_train_spread": spread_rows}), flush=True)
    outside = [(row["epoch"], k, v, row["jax"][k]) for row in spread_rows for k, (lo, hi) in FRONTEND_BANDS.items()
               for v in row[k] if not (math.isfinite(v) and lo * row["jax"][k] <= v <= hi * row["jax"][k])]
    if outside:
        raise AssertionError(f"frontend_train: (epoch, figure, port, JAX) outside {FRONTEND_BANDS}: {outside}")

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
        save_frontend_checkpoint(checkpoint_dir, FRONTEND_EPOCHS, state.network, config)
        loaded, render = load_frontend(checkpoint_dir, device=device)
    reloaded = loaded(images)
    round_trip = max(float((getattr(reloaded, k).float() - getattr(trained, k).float()).abs().max())
                     for k in ("points", "scores", "matched", "matches", "match_visibility"))
    if round_trip != 0.0 or render.image_size != FRONTEND_IMAGE_SIZE:
        raise AssertionError(f"frontend_train: the reloaded checkpoint differs by {round_trip}")
    tail = sorted(step_seconds)
    return dict(
        epochs=epochs, spread=spread_rows,
        recipe=dict(batch=config.batch_size, batches_per_epoch=config.batches_per_epoch,
                    val_batches=config.val_batches, image_size=FRONTEND_IMAGE_SIZE,
                    learning_rate=config.learning_rate, warmup_steps=config.warmup_steps,
                    schedule_epochs=config.epochs, epochs_run=FRONTEND_EPOCHS,
                    rate_at_stop=state.schedule(FRONTEND_EPOCHS * config.batches_per_epoch)),
        fit_seconds=seconds, epoch_seconds=[e["epoch_seconds"] for e in epochs],
        median_step_s=(tail[len(tail) // 2 - 1] + tail[len(tail) // 2]) / 2, peak_memory_gb=peak,
        k3_launches_train=launches["train"], k3_launches_val=launches["val"],
        launches=dict(match_attention=sum(launches["val"])), step_profile=busy,
        bands=FRONTEND_BANDS, seeds=[0, *FRONTEND_SPREAD_SEEDS],
        jax_reference_source="artifacts/frontend_v4_metrics.jsonl (jax.random draws, the same config)",
        checkpoint_round_trip_max_diff=round_trip,
    )


def calib_curriculum_phase(device):
    """The v2 calibration curriculum through fit_fov_curriculum at its full
    run's schedule, stopped after CURRICULUM_EPOCHS epochs of the first
    stage, validation cut to CURRICULUM_VAL_BATCHES; K1 and K2 counted
    from 0 just before it (the validation's eval solve; the train steps
    solve nothing); each epoch beside calib_v2_metrics.jsonl."""
    import dataclasses

    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import fit_fov_curriculum, get_preset

    config = dataclasses.replace(get_preset("calibration_transformer_curriculum"), val_batches=CURRICULUM_VAL_BATCHES,
                                 **CURRICULUM_RUN)
    reference = {}
    with open(CURRICULUM_REFERENCE_LOG) as f:
        for line in f:
            record = json.loads(line)
            reference.setdefault(record["epoch"], {})[f"{record['split']}_loss"] = record["loss"]
    rows = []

    def log_fn(split, epoch, metrics):
        if split == "train":
            rows.append(dict(epoch=epoch, train_loss=metrics["loss"], epoch_seconds=metrics["epoch_seconds"],
                             jax=reference[epoch]))
        else:
            rows[-1].update(val_loss=metrics["loss"], val_focal_length_loss=metrics["focal_length_loss"])
            print(json.dumps({"calib_curriculum_epoch": rows[-1]}), flush=True)

    torch.cuda.synchronize()
    build.reset_launch_counts()
    start = time.perf_counter()
    state, _ = fit_fov_curriculum(config, stages=((*CURRICULUM_FIRST_STAGE, CURRICULUM_EPOCHS),), log_fn=log_fn,
                                  device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(build.launch_counts)
    if not (launches.get("bfgs_update", 0) > 0 and launches.get("calibration_value_and_grad", 0) > 0):
        raise AssertionError(f"calib_curriculum: the validation's solve launched {launches}")
    if not all(math.isfinite(r[k]) for r in rows for k in ("train_loss", "val_loss")):
        raise AssertionError(f"calib_curriculum: not finite {rows}")
    bands = [within_band(f"calib_curriculum epoch {r['epoch']} train loss", r["train_loss"], r["jax"]["train_loss"],
                         CURRICULUM_BAND) for r in rows]
    recipe = dict(schedule_epochs=config.epochs, batches_per_epoch=config.batches_per_epoch, batch=config.batch_size,
                  val_batches=config.val_batches, warmup_steps=config.warmup_steps, stage=CURRICULUM_FIRST_STAGE)
    return dict(
        epochs=rows, bands=bands, band=CURRICULUM_BAND, launches=launches, fit_seconds=seconds, steps=state.step,
        rate_at_stop=state.schedule(state.step), recipe=recipe,
        jax_reference_source="artifacts/runs/calib_v2_metrics.jsonl (jax.random draws, 16 validation batches)",
    )


def _timed(fn, totals, name):
    """``fn`` with its seconds (host clock, synchronised) added to
    ``totals[name]``."""
    def wrapped(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t0
        return out

    return wrapped


def vo_clean_inputs(dtype, device, seed=0):
    """The accumulator's clean case, built without JAX: a 10-frame, 8-point
    sequence (a CPU generator seeded ``seed``, float64), oracle detections
    among 12 a frame (numpy's default_rng(7) places them and the junk,
    as the JAX test does), scores 0.9 for the visible, 0.4 for junk."""
    import numpy as np
    from davo_tpu_torch.train.vo_eval import TrajectoryConfig, _to_window_frame, generate_trajectory

    cfg = TrajectoryConfig(num_frames=10, num_points=8, dtype=torch.float64)
    poses, _, pixels, vis = generate_trajectory(torch.Generator("cpu").manual_seed(seed), cfg, device="cpu")
    kf, d = cfg.num_frames, 12
    rng = np.random.default_rng(7)
    dets = 0.95 * (2.0 * rng.random((kf, d, 2)) - 1.0)
    scores = np.full((kf, d), 0.4)
    for k in range(kf):
        order = rng.permutation(d)[: cfg.num_points]
        dets[k, order] = pixels[k].numpy()
        scores[k, order] = np.where(vis[k].numpy(), 0.9, 0.0)
    inputs = (dets, scores, [cfg.focal_length, 0.0, 0.0], _to_window_frame(poses[:2], poses[0]), pixels[:2], vis[:2])
    return poses, [torch.as_tensor(x).to(device=device, dtype=dtype) for x in inputs]


def vo_clean_accumulator(device):
    """solve_incremental_vo_detections on the clean case with ba_irls 1,
    pnp_ransac 4, chain_passes 2 and reject_outliers: the card in float32
    against the CPU in float64 (rotation matrices and translations, so
    that a rotation of pi written with either sign agrees), and the card's
    ATE below VO_CLEAN_ATE_TOL (the JAX test's bound)."""
    from davo_tpu_torch.geometry import so3_rotation_matrix
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train.evaluation import absolute_trajectory_error, camera_centers_from_poses
    from davo_tpu_torch.train.vo_eval import solve_incremental_vo_detections

    out = {}
    for dev, dtype in ((device, torch.float32), (torch.device("cpu"), torch.float64)):
        poses, inputs = vo_clean_inputs(dtype, dev)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        est, cost = solve_incremental_vo_detections(
            *inputs, ba_irls=1, pnp_ransac=4, chain_passes=2, reject_outliers=True, return_cost=True
        )
        est = est.double().cpu()
        seconds = time.perf_counter() - t0
        ate = float(absolute_trajectory_error(camera_centers_from_poses(est[:, :3], est[:, 3:]),
                                              camera_centers_from_poses(poses[:, :3], poses[:, 3:]))["rmse"])
        out[dev.type] = dict(poses=est, cost=cost, ate_rmse=ate, seconds=seconds, launches=dict(build.launch_counts))
    card, cpu = out["cuda"], out["cpu"]
    rotation_err = float((so3_rotation_matrix(card["poses"][:, :3]) - so3_rotation_matrix(cpu["poses"][:, :3])).abs().max())
    translation_err = float((card["poses"][:, 3:] - cpu["poses"][:, 3:]).abs().max())
    if not (rotation_err <= VO_CLEAN_ROTATION_TOL and translation_err <= VO_CLEAN_TRANSLATION_TOL):
        raise AssertionError(f"vo_eval clean accumulator: card against CPU rotation {rotation_err}, "
                             f"translation {translation_err}")
    if not card["ate_rmse"] < VO_CLEAN_ATE_TOL:
        raise AssertionError(f"vo_eval clean accumulator: card ATE {card['ate_rmse']} >= {VO_CLEAN_ATE_TOL}")
    if any(card["launches"].values()):
        raise AssertionError(f"vo_eval clean accumulator launched kernels {card['launches']}")
    return dict(frames=10, points=8, detections_per_frame=12, options="ba_irls 1, pnp_ransac 4, chain_passes 2, "
                "reject_outliers", rotation_max_abs_err=rotation_err, translation_max_abs_err=translation_err,
                rotation_tolerance=VO_CLEAN_ROTATION_TOL, translation_tolerance=VO_CLEAN_TRANSLATION_TOL,
                ate_rmse_card=card["ate_rmse"], ate_rmse_cpu=cpu["ate_rmse"], cost_card=card["cost"],
                cost_cpu=cpu["cost"], seconds_card=card["seconds"], seconds_cpu=cpu["seconds"])


def vo_eval_phase(device):
    """Learned VO from pixels through the port's vo-eval code
    (``cli.vo_eval_setup``, then ``evaluate_learned_vo``) at the official
    recipe, trial 0; launches counted from 0 just before the trial and
    read just after; the trial's seconds split into the front end (its
    whole-sequence and window calls), the bootstrap solves (the guess
    network and its eval solve) and the rest (the accumulator, with the
    sequence's generation and rendering); peak memory; the chosen
    bootstrap and every bootstrap's cost; beside the JAX log's trial 0.
    Then the accumulator on fixed clean inputs, card against CPU."""
    from davo_tpu_torch import cli
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train.vo_eval import evaluate_learned_vo

    args = cli._build_parser().parse_args(VO_EVAL_ARGS)
    config, kwargs = cli.vo_eval_setup(args, device)
    totals = {"front_end": 0.0, "bootstrap_solves": 0.0}
    kwargs["guess_fn"] = _timed(kwargs["guess_fn"], totals, "bootstrap_solves")
    for name in ("frontend_fn", "detections_fn"):
        kwargs[name] = _timed(kwargs[name], totals, "front_end")
    debug = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    ate = evaluate_learned_vo(generator=torch.Generator(device).manual_seed(100), config=config, debug_out=debug,
                              **kwargs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    ate = {k: float(v) for k, v in ate.items()}
    for counter in ("bfgs_update", "calibration_value_and_grad", "match_attention"):
        if not launches.get(counter, 0) > 0:
            raise AssertionError(f"vo_eval: {counter} was never launched on the path ({launches})")
    if not all(math.isfinite(v) for v in ate.values()):
        raise AssertionError(f"vo_eval: ATE not finite {ate}")
    with open(VO_EVAL_REFERENCE_LOG) as f:
        jax_trial0 = next(json.loads(line) for line in f if line.startswith('{"trial": 0'))
    return dict(
        recipe=" ".join(VO_EVAL_ARGS[3:]), ate=ate, jax_trial0=jax_trial0, seconds_trial=seconds,
        seconds_split=dict(front_end=totals["front_end"], bootstrap_solves=totals["bootstrap_solves"],
                           accumulator_and_rest=seconds - totals["front_end"] - totals["bootstrap_solves"]),
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches,
        chosen_bootstrap=debug["chosen_bootstrap"], bootstrap_costs=debug["bootstrap_costs"],
        clean_accumulator=vo_clean_accumulator(device),
    )


def _ate_rmse(estimates, poses):
    from davo_tpu_torch.train.evaluation import absolute_trajectory_error, camera_centers_from_poses

    est, poses = estimates.double(), poses.double()
    return float(absolute_trajectory_error(camera_centers_from_poses(est[:, :3], est[:, 3:]),
                                           camera_centers_from_poses(poses[:, :3], poses[:, 3:]))["rmse"])


def _jax_trials(log, section=None):
    """The trial lines' ATE rmse of a JAX log (of the block headed
    ``=== <section> ===`` where the log holds several)."""
    trials, inside = [], section is None
    with open(log) as f:
        for line in f:
            if line.startswith("==="):
                inside = section is not None and line.strip("= \n") == section
            elif inside and line.startswith('{"trial"'):
                trials.append(json.loads(line)["rmse"])
    return trials


def vo_windows_recovery(device, frames=16, seed=0):
    """The windows pipeline on oracle guesses (tests/train/test_vo_eval.py's
    construction): each window's truth calibration at the gauge scale
    1 + 0.4 (i + 1) of window i, solved in one stacked call, stitched
    (chain and global) and refined on the card in float32; the refined ATE
    within VO_RECOVERY_ATE."""
    from davo_tpu_torch.camera import CalibrationParameters, pack_calibration_parameters
    from davo_tpu_torch.geometry import so3_rotation_matrix
    from davo_tpu_torch.train.vo_eval import (
        TrajectoryConfig,
        _to_window_frame,
        _window_starts,
        generate_trajectory,
        refine_trajectory_global,
        solve_windowed_vo_learned,
    )

    cfg = TrajectoryConfig(num_frames=frames, num_points=N, window=M)
    poses, points, pixels, vis = generate_trajectory(torch.Generator(device).manual_seed(seed), cfg, device=device)
    f = cfg.focal_length
    vectors = []
    for i, s in enumerate(_window_starts(frames, M, M - 2)):
        rel = _to_window_frame(poses[s: s + M], poses[s])
        scale = 1.0 + 0.4 * (i + 1)
        pts = points @ so3_rotation_matrix(poses[s, 0:3]).T + poses[s, 3:6]
        vectors.append(pack_calibration_parameters(CalibrationParameters(
            intrinsics=torch.tensor([f - 1.0 if f >= 1.0 else math.log(f), 0.0, 0.0], device=device).reshape(1, 1, 3),
            world_points=(scale * pts).reshape(1, -1, 3),
            camera_translations=(scale * rel[1:, 3:6]).reshape(M - 1, 1, 3),
            camera_rotations=rel[1:, 0:3].reshape(M - 1, 1, 3),
        )).reshape(-1))
    vectors = torch.stack(vectors)

    def guess_fn(pixels_windows, visibility_windows):
        if pixels_windows.shape[0] != vectors.shape[0]:
            raise AssertionError(f"{pixels_windows.shape[0]} windows stacked, {vectors.shape[0]} expected")
        return vectors

    intrinsics = torch.tensor([f, 0.0, 0.0], device=device)
    out = {}
    for stitch in ("chain", "global"):
        stitched = solve_windowed_vo_learned(guess_fn, pixels, vis, cfg, stitch=stitch)
        refined = refine_trajectory_global(stitched, intrinsics, pixels, vis)
        out[stitch] = dict(stitched_ate=_ate_rmse(stitched, poses), refined_ate=_ate_rmse(refined, poses))
        if not out[stitch]["refined_ate"] <= VO_RECOVERY_ATE:
            raise AssertionError(f"vo_windows recovery ({stitch}): refined ATE {out[stitch]} > {VO_RECOVERY_ATE}")
    return dict(frames=frames, windows=vectors.shape[0], gauge_scales="1 + 0.4 (i + 1)", bound=VO_RECOVERY_ATE,
                dtype="float32", **out)


def vo_windows_phase(device):
    """The JAX CLI's vo-eval default at v6_verified's width, trial 0,
    through the port's code (cli.vo_eval_setup, then evaluate_learned_vo),
    launches counted from 0 just before the trial; then from the same
    window solves (the trial's debug_out): chain, global and robust
    stitching, multistart with the float64 polish (the card's polish
    against the CPU's, float64), correct_scale_drift (launches counted
    from 0 just before it: K1 at P = 15); the oracle-guess recovery check;
    learned matches (trial 0, launches counted); the seconds split and
    peak memory; beside the JAX logs."""
    from davo_tpu_torch import cli
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train.vo_eval import (
        correct_scale_drift,
        evaluate_learned_vo,
        refine_trajectory_global,
        refine_trajectory_host_f64,
        refine_trajectory_multistart,
        stitch_windows,
    )

    def timed(name, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        return out

    args = cli._build_parser().parse_args(VO_WINDOWS_ARGS)
    config, kwargs = cli.vo_eval_setup(args, device)
    totals = {"window_solves": 0.0}
    kwargs["guess_fn"] = _timed(kwargs["guess_fn"], totals, "window_solves")
    seconds, debug = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    ate = timed("trial", evaluate_learned_vo, generator=torch.Generator(device).manual_seed(100), config=config,
                debug_out=debug, **kwargs)
    launches = dict(build.launch_counts)
    ate = {k: float(v) for k, v in ate.items()}
    for counter in ("bfgs_update", "calibration_value_and_grad"):
        if not launches.get(counter, 0) > 0:
            raise AssertionError(f"vo_windows: {counter} was never launched on the path ({launches})")
    if not all(math.isfinite(v) for v in ate.values()):
        raise AssertionError(f"vo_windows: ATE not finite {ate}")
    seconds["window_solves"] = totals["window_solves"]
    starts, window_poses = debug["window_starts"], debug["window_poses"]
    pixels, vis, poses, intrinsics = debug["pixels"], debug["visibility"], debug["true_poses"], debug["intrinsics"]
    stitched = {mode: timed(f"stitch_{mode}", stitch_windows, starts, window_poses, pixels.shape[0], mode)
                for mode in ("chain", "global", "robust")}
    refined = timed("refinement", refine_trajectory_global, stitched["global"], intrinsics, pixels, vis)
    multistart = timed("multistart", refine_trajectory_multistart, stitched["global"], intrinsics, pixels, vis,
                       torch.Generator(device).manual_seed(107), num_hypotheses=VO_MULTISTART)
    polished = timed("polish", refine_trajectory_host_f64, multistart, intrinsics, pixels, vis)
    # the float64 polish on the card against the same polish on the CPU
    card64 = refine_trajectory_host_f64(multistart.double(), intrinsics, pixels, vis).cpu()
    cpu64 = refine_trajectory_host_f64(*(x.cpu().double() if x.is_floating_point() else x.cpu()
                                         for x in (multistart, intrinsics, pixels, vis)))
    polish_check = check("vo_windows float64 polish, card against CPU", card64, cpu64, VO_POLISH_TOL)
    build.reset_launch_counts()
    drift = timed("scale_drift", correct_scale_drift, stitched["global"], intrinsics, pixels, vis)
    drift_launches = dict(build.launch_counts)
    if not drift_launches.get("bfgs_update", 0) > 0:
        raise AssertionError(f"vo_windows: K1 never launched at P = {VO_DRIFT_P} ({drift_launches})")
    recovery = timed("recovery_check", vo_windows_recovery, device)
    peak = torch.cuda.max_memory_allocated() / 1e9

    learned_args = cli._build_parser().parse_args(VO_WINDOWS_LEARNED_ARGS)
    l_config, l_kwargs = cli.vo_eval_setup(learned_args, device)
    build.reset_launch_counts()
    l_ate = timed("learned_trial", evaluate_learned_vo, generator=torch.Generator(device).manual_seed(100),
                  config=l_config, **l_kwargs)
    l_launches = dict(build.launch_counts)
    l_ate = {k: float(v) for k, v in l_ate.items()}
    for counter in ("bfgs_update", "calibration_value_and_grad", "match_attention"):
        if not l_launches.get(counter, 0) > 0:
            raise AssertionError(f"vo_windows learned: {counter} was never launched on the path ({l_launches})")
    if not all(math.isfinite(v) for v in l_ate.values()):
        raise AssertionError(f"vo_windows learned: ATE not finite {l_ate}")
    logs = VO_WINDOWS_LOGS
    return dict(
        recipe=" ".join(VO_WINDOWS_ARGS[3:]), trial=0, windows=len(starts), stacked_batch=VO_WINDOWS_BATCH,
        ate=ate, launches=launches,
        stitched_ate={mode: _ate_rmse(est, poses) for mode, est in stitched.items()},
        refined_ate=_ate_rmse(refined, poses), multistart_ate=_ate_rmse(multistart, poses),
        multistart_polished_ate=_ate_rmse(polished, poses), polish_card_vs_cpu=polish_check,
        scale_drift=dict(ate_before=_ate_rmse(stitched["global"], poses), ate_after=_ate_rmse(drift, poses),
                         p=VO_DRIFT_P, batch=VO_DRIFT_BATCH, launches=drift_launches),
        recovery=recovery, seconds_split=seconds, peak_memory_gb=peak,
        learned_matches=dict(recipe=" ".join(VO_WINDOWS_LEARNED_ARGS[len(VO_WINDOWS_ARGS):]), ate=l_ate,
                             launches=l_launches, readme_ate="~9 (README.md:79, per-window solving + stitching)",
                             jax_eval_learned_v3=_jax_trials(logs["eval_learned_v3"], "refined, conf 0.3, nms 0.1")),
        jax_eval_v3_vo=_jax_trials(logs["eval_v3_vo"]), jax_eval_v3_vo_raw=_jax_trials(logs["eval_v3_vo_raw"]),
        jax_stitch_compare={mode: _jax_trials(logs["eval_stitch_compare"], f"--stitch {mode}")
                            for mode in ("chain", "global")},
    )


def random_checkpoint(path, num_views, num_points, seed=0):
    """v6_verified's architecture (embed 384, 8 layers, 8 heads) at
    ``num_views`` x ``num_points`` with flax-style random weights drawn from
    ``seed``, pickled as the JAX package's numpy checkpoint."""
    import pickle

    from davo_tpu_torch.models import state_dict_to_flax
    from davo_tpu_torch.train import CalibrationExperiment

    network = CalibrationExperiment(num_views=num_views, num_points=num_points, hidden_size=384, head="transformer",
                                    transformer_layers=8, transformer_heads=8).build_network(
        "cpu", generator=torch.Generator().manual_seed(seed))
    params, batch_stats = state_dict_to_flax(network.state_dict(), num_heads=8)
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batch_stats": batch_stats}, f)


# ------------------------------------------------------------- orbax ----


def _same_leaves(got, want, path=""):
    """The number of arrays in ``want``; raises unless ``got`` has its
    structure and each array's dtype, shape and bytes."""
    import numpy as np

    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"orbax: {path or '/'} differs in its keys")
        return sum(_same_leaves(got[k], want[k], f"{path}/{k}") for k in want)
    want = np.asarray(want)
    if not isinstance(got, np.ndarray) or (got.dtype, got.shape) != (want.dtype, want.shape) \
            or got.tobytes() != want.tobytes():
        raise AssertionError(f"orbax: {path} is not bit for bit the reference's")
    return 1


def _within(name, value, reference, band):
    if not band[0] * reference <= value <= band[1] * reference:
        raise AssertionError(f"orbax: {name} {value} is outside {band} x the JAX figure {reference}")


def orbax_phase(device):
    """The JAX package's Orbax stores read by the port and served on the
    card (see ORBAX_STORES): the reads' seconds and MB/s, the two
    bit-equality checks, and three paths each counted from 0 just before
    it."""
    import dataclasses

    from davo_tpu_torch import cli
    from davo_tpu_torch.data import VOWindowConfig, generate_vo_window_batch
    from davo_tpu_torch.models import load_frontend, load_frontend_npz
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.scripts.time_orbax_reads import PICKLE_DIGESTS, STORES, host, read_store, tree_digest
    from davo_tpu_torch.train import FrontendExperiment, frontend_eval_metrics, render_scene_batch

    out = {"host": host()}
    trees = {}
    for name in ORBAX_STORES:
        read = read_store(STORES[name])
        trees[name] = read["tree"]
        out.setdefault("reads", {})[name] = read["figures"]
    out["v4_equals_npz_arrays"] = _same_leaves(trees["frontend_v4"], load_frontend_npz(FRONTEND_NPZ))
    pickle_path, pickle_digest = PICKLE_DIGESTS["v5_tokens_1800"]
    if tree_digest(trees["v5_tokens_1800"]) != pickle_digest:
        raise AssertionError(f"orbax: v5_tokens/1800 is not bit for bit {pickle_path} (its digest differs)")
    out["v5_tokens_1800_equals_pickle_digest"] = dict(pickle=pickle_path, sha256=pickle_digest)
    del trees

    # frontend_v2: one learned-match window request, the front end read from its Orbax directory
    frontend, render_config = load_frontend(STORES["frontend_v2"].parent, device=device)
    network = serve_network(device, checkpoint=WINDOW_CHECKPOINT)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    windows = generate_vo_window_batch(torch.Generator(device).manual_seed(0), WINDOWS, VOWindowConfig(), device=device)
    images = render_scene_batch(torch.Generator(device).manual_seed(1000), windows, render_config)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    matches = frontend(images)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    params, error = network(matches.matches, matches.match_visibility,
                            generator=torch.Generator(device).manual_seed(2000), return_error=True)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(build.launch_counts)
    metrics = frontend_eval_metrics(matches, windows, FrontendExperiment(render=render_config))
    if images.shape != (WINDOWS, M, ORBAX_CELLS, ORBAX_CELLS, 3) or not torch.isfinite(params).all():
        raise AssertionError(f"orbax frontend_v2: images {tuple(images.shape)} or a solve that is not finite")
    v2 = dict(
        windows=WINDOWS, image_size=render_config.image_size, latency_s=t3 - t0, generate_render_s=t1 - t0,
        frontend_s=t2 - t1, solve_s=t3 - t2, match_inlier_rate=metrics["match_inlier_rate"].item(),
        visible_match_share=matches.match_visibility.float().mean().item(), mean_final_error=error.mean().item(),
        f_error_mean=focal_error(params, windows).mean().item(), launches=launches,
        jax_match_inlier_rate=ORBAX_INLIER_REFERENCE["frontend_v2"][0],
        jax_reference_source=ORBAX_INLIER_REFERENCE["frontend_v2"][1] + " (last line)",
        band=ORBAX_INLIER_BAND["frontend_v2"],
    )
    del network, frontend, images, matches
    torch.cuda.empty_cache()

    # frontend_v3: one validation batch of its fit-frontend recipe (16 points, select 16, 64 px)
    frontend, render_config = load_frontend(STORES["frontend_v3"].parent, device=device)
    experiment = FrontendExperiment(num_points=ORBAX_V3_POINTS, num_select=frontend.num_select, render=render_config)
    window_config = dataclasses.replace(VOWindowConfig(), num_points=ORBAX_V3_POINTS)
    generator = torch.Generator(device).manual_seed(600)
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    windows = generate_vo_window_batch(generator, ORBAX_V3_BATCH, window_config, device=device)
    matches = frontend(render_scene_batch(generator, windows, render_config))
    metrics = frontend_eval_metrics(matches, windows, experiment)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    v3 = dict(
        windows=ORBAX_V3_BATCH, points=ORBAX_V3_POINTS, num_select=frontend.num_select,
        image_size=render_config.image_size, seconds=seconds, launches=dict(build.launch_counts),
        **{k: v.item() for k, v in metrics.items()},
        jax_match_inlier_rate=ORBAX_INLIER_REFERENCE["frontend_v3"][0],
        jax_reference_source=ORBAX_INLIER_REFERENCE["frontend_v3"][1] + " (last line)",
        band=ORBAX_INLIER_BAND["frontend_v3"],
    )
    if matches.matches.shape != (ORBAX_V3_BATCH, M, ORBAX_V3_POINTS, 2):
        raise AssertionError(f"orbax frontend_v3: matches of shape {tuple(matches.matches.shape)}")
    del frontend, matches
    torch.cuda.empty_cache()

    # v5_tokens: cli eval through the Orbax checkpoint directory
    reference = jax_reference("recipe_evals_r5.log", "v5t_tokens8_error")
    build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = cli.run(V5_EVAL_ARGS)
    torch.cuda.synchronize()
    v5 = dict(
        result=result, scenes=V5_EVAL_BATCH, seconds=time.perf_counter() - t0, launches=dict(build.launch_counts),
        jax_reference={k: reference[k] for k in ("ate_rmse_mean", "ate_rmse_median", "f_error_mean")},
        jax_reference_source="artifacts/recipe_evals_r5.log (v5t_tokens8_error, 256 scenes, jax.random draws)",
        band=EVAL_RESTART_BAND,
    )
    out.update(frontend_v2=v2, frontend_v3=v3, v5_eval=v5)
    for name, path, counters in (("frontend_v2", v2, ("bfgs_update", "calibration_value_and_grad",
                                                      "match_attention")),
                                 ("frontend_v3", v3, ("match_attention",)),
                                 ("v5_eval", v5, ("bfgs_update", "calibration_value_and_grad"))):
        for counter in counters:
            if path["launches"][counter] <= 0:
                raise AssertionError(f"orbax {name}: never launched kernel {counter}")
    if not all(math.isfinite(v) for v in result.values()):
        raise AssertionError(f"orbax v5_eval: non-finite metrics {result}")
    for name in ("frontend_v2", "frontend_v3"):
        _within(f"{name} match_inlier_rate", out[name]["match_inlier_rate"], ORBAX_INLIER_REFERENCE[name][0],
                ORBAX_INLIER_BAND[name])
    for key in ("ate_rmse_mean", "f_error_mean"):
        _within(f"v5_eval {key}", result[key], reference[key], EVAL_RESTART_BAND)
    return out


def _epoch_metrics(lines, split, epoch):
    """The metrics of ``split`` at ``epoch`` among a training entry's lines
    (without the times and the run's id)."""
    for line in lines:
        record = json.loads(line) if line.startswith("{") else {}
        if record.get("split") == split and record.get("epoch") == epoch:
            return {k: v for k, v in record.items()
                    if k not in ("split", "epoch", "epoch_seconds", "elapsed_s", "run_id")}
    raise AssertionError(f"orbax_write: no {split} line at epoch {epoch}")


def _jax_chain_layout(tree, path):
    """Raise unless ``tree``'s opt_state is the JAX trainer's optax chain:
    [clip, [adam {count, mu, nu}, weight decay, schedule {count}]]."""
    opt = tree["opt_state"]
    if not (isinstance(opt, list) and opt[0] is None and isinstance(opt[1], list) and len(opt[1]) == 3
            and set(opt[1][0]) == {"count", "mu", "nu"} and opt[1][1] is None and set(opt[1][2]) == {"count"}):
        raise AssertionError(f"orbax_write: {path} does not hold the JAX chain's opt_state layout")


def orbax_write_phase(device):
    """The port's Orbax writer on the card's host and the card serving
    from what it wrote (see ORBAX_WRITE_CONFIG): every store's round trip,
    cli fit's 1 + 1 epochs against 2 through Orbax directories, cli eval
    from the written directory and a front end trained, written, read back
    and served; the two served paths each counted from 0 just before it."""
    import davo_tpu_torch.train as train_package
    from davo_tpu_torch import cli
    from davo_tpu_torch.data import VOWindowConfig, generate_vo_window_batch
    from davo_tpu_torch.models import load_frontend
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.scripts.time_orbax_reads import STORES, host
    from davo_tpu_torch.scripts.time_orbax_writes import round_trip
    from davo_tpu_torch.train import fit, latest_step, load_config_yaml, render_scene_batch, restore_checkpoint

    out = {"host": host(), "cpus_usable": len(os.sched_getaffinity(0))}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ORBAX_STORES:
            t0 = time.perf_counter()
            figures = round_trip(STORES[name], os.path.join(tmp, name), repeats=2)
            figures["seconds"] = time.perf_counter() - t0
            if figures["digest_read"] != figures["digest_written"]:
                raise AssertionError(f"orbax_write: {name} read back differs from what was written")
            out.setdefault("round_trips", {})[name] = figures

        # cli fit: 2 epochs whole; 1 epoch by fit, then cli fit resuming from its Orbax directory
        config_path, registry = os.path.join(tmp, "fit.yaml"), os.path.join(tmp, "runs")
        with open(config_path, "w") as f:
            json.dump(ORBAX_WRITE_CONFIG, f)  # JSON is YAML
        fit_args = ["fit", "--config", config_path, "--registry-dir", registry, "--checkpoint-dir"]
        whole_dir, split_dir = os.path.join(tmp, "whole"), os.path.join(tmp, "split")
        t0 = time.perf_counter()
        code, whole = _cli_lines(fit_args + [whole_dir])
        t1 = time.perf_counter()
        fit(load_config_yaml(config_path), epochs=1, checkpoint_dir=split_dir, device=device)
        first = restore_checkpoint(split_dir, 1)
        _jax_chain_layout(first, "checkpoint_1")
        t2 = time.perf_counter()
        code_resumed, resumed = _cli_lines(fit_args + [split_dir])
        t3 = time.perf_counter()
        if (code, code_resumed) != (0, 0) or whole[-2] != f"checkpoint: {whole_dir}/checkpoint_2" \
                or resumed[-2] != f"checkpoint: {split_dir}/checkpoint_2":
            raise AssertionError(f"orbax_write: cli fit exited {code}, {code_resumed}: {whole[-3:]} {resumed[-3:]}")
        if sum(1 for line in resumed if '"split": "train"' in line) != 1 or latest_step(split_dir) != 2:
            raise AssertionError(f"orbax_write: the resumed cli fit did not train one epoch: {resumed}")
        worst = 0.0
        for split in ("train", "val"):
            want, got = _epoch_metrics(whole, split, 1), _epoch_metrics(resumed, split, 1)
            for key, value in want.items():
                worst = max(worst, abs(got[key] - value) / max(abs(value), 1e-30))
        if worst > RESUME_TOL:
            raise AssertionError(f"orbax_write: the resumed epoch differs from the uninterrupted one by {worst}")
        _jax_chain_layout(restore_checkpoint(whole_dir), "checkpoint_2")
        out["fit"] = dict(
            config=ORBAX_WRITE_CONFIG, epochs="1 + 1 against 2", worst_relative_diff=worst, tolerance=RESUME_TOL,
            equal=worst == 0.0, whole_seconds=t1 - t0, first_epoch_seconds=t2 - t1, resumed_seconds=t3 - t2,
            checkpoint_mb=sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                              os.walk(os.path.join(whole_dir, "checkpoint_2")) for f in fs) / 1e6,
            printed=whole[-2], final_val=json.loads(whole[-1])["final_val"],
        )

        # cli eval from the written directory
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = cli.run(ORBAX_WRITE_EVAL_ARGS + ["--checkpoint-dir", whole_dir])
        torch.cuda.synchronize()
        out["eval"] = dict(result=result, scenes=64, seconds=time.perf_counter() - t0,
                           launches=dict(build.launch_counts))
        if not all(math.isfinite(v) for v in result.values()):
            raise AssertionError(f"orbax_write eval: non-finite metrics {result}")

        # fit-frontend into an Orbax directory, the trained module kept to compare
        frontend_dir, trained = os.path.join(tmp, "frontend"), {}
        fit_frontend = train_package.fit_frontend

        def keep(*args, **kwargs):
            trained["state"], history = fit_frontend(*args, **kwargs)
            return trained["state"], history

        train_package.fit_frontend = keep
        try:
            t0 = time.perf_counter()
            code, lines = _cli_lines(ORBAX_WRITE_FRONTEND_ARGS + ["--checkpoint-dir", frontend_dir,
                                                                  "--registry-dir", registry])
            fit_seconds = time.perf_counter() - t0
        finally:
            train_package.fit_frontend = fit_frontend
        if code != 0 or lines[-2] != f"checkpoint: {frontend_dir}/checkpoint_1":
            raise AssertionError(f"orbax_write: fit-frontend exited {code}: {lines[-3:]}")
        frontend, render_config = load_frontend(frontend_dir, device=device)
        memory = trained.pop("state").network.eval()
        loaded, kept = frontend.state_dict(), memory.state_dict()
        if loaded.keys() != kept.keys() or not all(torch.equal(loaded[k], kept[k]) for k in kept):
            raise AssertionError("orbax_write: the front end read back is not the trained one bit for bit")
        network = serve_network(device, checkpoint=WINDOW_CHECKPOINT)
        build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        windows = generate_vo_window_batch(torch.Generator(device).manual_seed(0), WINDOWS, VOWindowConfig(),
                                           device=device)
        images = render_scene_batch(torch.Generator(device).manual_seed(1000), windows, render_config)
        matches = frontend(images)
        params, error = network(matches.matches, matches.match_visibility,
                                generator=torch.Generator(device).manual_seed(2000), return_error=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(build.launch_counts)
        with torch.no_grad():
            in_memory = memory(images)
        same = torch.equal(in_memory.matches, matches.matches) and torch.equal(
            in_memory.match_visibility, matches.match_visibility)
        if not same:
            raise AssertionError("orbax_write: the front end read back matches otherwise than the trained one")
        if params.shape != (WINDOWS, network.num_parameters) or not torch.isfinite(params).all() \
                or not torch.isfinite(error).all():
            raise AssertionError("orbax_write frontend: a solve that is not finite")
        out["frontend"] = dict(
            fit_seconds=fit_seconds, printed=lines[-2], final=json.loads(lines[-1])["final"], windows=WINDOWS,
            image_size=render_config.image_size, num_select=frontend.num_select, latency_s=seconds,
            matches_equal_in_memory=same, visible_match_share=matches.match_visibility.float().mean().item(),
            mean_final_error=error.mean().item(), launches=launches,
        )
    for name, counters in (("eval", ("bfgs_update", "calibration_value_and_grad")),
                           ("frontend", ("bfgs_update", "calibration_value_and_grad", "match_attention"))):
        for counter in counters:
            if out[name]["launches"][counter] <= 0:
                raise AssertionError(f"orbax_write {name}: never launched kernel {counter}")
    return out


def eval_seq_phase(device):
    """python -m davo_tpu_torch.cli eval-seq on the fixtures: compare mode,
    oracle VO and learned VO along the KITTI file through the front end, at
    8 points and at the CLI's default 32 (launches counted from 0 just
    before each: K1, K2, K3; the seconds of its window solves apart); every
    figure finite."""
    from davo_tpu_torch import cli
    from davo_tpu_torch.ops import build

    out, guess_fn = {}, cli._guess_fn
    scratch = tempfile.TemporaryDirectory()
    checkpoint_32 = os.path.join(scratch.name, f"random_4x{EVAL_SEQ_POINTS}.pkl")
    random_checkpoint(checkpoint_32, 4, EVAL_SEQ_POINTS)
    frontend_32 = os.path.join(scratch.name, "frontend")
    code, lines = _cli_lines(EVAL_SEQ_FRONTEND_ARGS + ["--checkpoint-dir", frontend_32, "--registry-dir",
                                                      os.path.join(scratch.name, "runs")])
    if code != 0:
        raise AssertionError(f"eval_seq: fit-frontend at {EVAL_SEQ_POINTS} points exited {code}: {lines[-3:]}")
    cases = dict(EVAL_SEQ_CASES, learned_32=EVAL_SEQ_32_ARGS + ["--checkpoint", checkpoint_32, "--frontend-checkpoint",
                                                               frontend_32])
    for name, argv in cases.items():
        totals = {"window_solves": 0.0}
        cli._guess_fn = lambda net: _timed(guess_fn(net), totals, "window_solves")
        build.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            result = cli.run(argv)
        finally:
            cli._guess_fn = guess_fn
        torch.cuda.synchronize()
        out[name] = dict(metrics=result, seconds=time.perf_counter() - t0, launches=dict(build.launch_counts),
                         seconds_window_solves=totals["window_solves"])
        if not all(math.isfinite(v) for v in result.values()):
            raise AssertionError(f"eval_seq {name}: not finite {result}")
    scratch.cleanup()
    for name in ("learned", "learned_32"):
        for counter in ("bfgs_update", "calibration_value_and_grad", "match_attention"):
            if not out[name]["launches"].get(counter, 0) > 0:
                raise AssertionError(f"eval_seq {name}: {counter} was never launched ({out[name]['launches']})")
    for key in ("rmse", "rpe_trans_rmse"):
        if key not in out["learned_32"]["metrics"]:
            raise AssertionError(f"eval_seq learned_32: no {key} in {out['learned_32']['metrics']}")
    return out


# ---------------------------------------------------- multi-device ----


def multidevice_problem(device):
    """tests/parallel/test_schur.py's problem (4 views, 16 points, start
    noise 0.02), float64, drawn by a CPU generator."""
    from davo_tpu_torch.geometry import rotate_vector_axis_angle
    from davo_tpu_torch.parallel import BAObservations, BAProblem

    g = torch.Generator().manual_seed(0)
    m, n = 4, 16
    points = torch.cat([2.0 * torch.randn(n, 2, generator=g, dtype=torch.float64),
                        8.0 + torch.randn(n, 1, generator=g, dtype=torch.float64)], dim=-1)
    poses = torch.zeros(m, 6, dtype=torch.float64)
    poses[1:, 0:3] = 0.05 * torch.randn(m - 1, 3, generator=g, dtype=torch.float64)
    poses[1:, 3:5] = 0.5 * torch.randn(m - 1, 2, generator=g, dtype=torch.float64)
    intrinsics = torch.tensor([1.4, 0.05, -0.05], dtype=torch.float64)
    rel = rotate_vector_axis_angle(points[None], poses[:, None, 0:3]) + poses[:, None, 3:6]
    pixels = torch.stack([1.4 * rel[..., 0] / rel[..., 2] + 0.05, 1.4 * rel[..., 1] / rel[..., 2] - 0.05], dim=-1)
    start = BAProblem(intrinsics + 0.02 * torch.randn(3, generator=g, dtype=torch.float64),
                      poses + torch.cat([torch.zeros(1, 6, dtype=torch.float64),
                                         0.02 * torch.randn(m - 1, 6, generator=g, dtype=torch.float64)]),
                      points + 0.02 * torch.randn(n, 3, generator=g, dtype=torch.float64))
    obs = BAObservations(pixels, torch.ones(m, n, dtype=torch.bool))
    return (BAProblem(*(x.to(device) for x in start)), BAObservations(*(x.to(device) for x in obs)))


def multidevice_windows(device):
    """8 frames of vo_eval's orbit as windows of 4 at stride 2, each in its
    own gauge scale with 0.01 noise, float64 (CPU draws)."""
    from davo_tpu_torch.train import vo_eval as V

    frames, window = 8, 4
    config = V.TrajectoryConfig(num_frames=frames, window=window, dtype=torch.float64)
    poses = V.generate_trajectory(torch.Generator().manual_seed(5), config, device="cpu")[0]
    starts = V._window_starts(frames, window, window - 2)
    g = torch.Generator().manual_seed(6)
    window_poses = []
    for s in starts:
        rel = V._to_window_frame(poses[s : s + window], poses[s])
        rel[:, 3:6] *= math.exp(0.3 * float(torch.randn(1, generator=g, dtype=torch.float64)))
        rel[1:] += 0.01 * torch.randn(window - 1, 6, generator=g, dtype=torch.float64)
        window_poses.append(rel.to(device))
    return starts, window_poses, frames


def multidevice_step(device, mesh):
    """One data-parallel step of the MLP head (hidden 64, batch 64, a
    3-iteration unrolled solve with drop-path 0.1, float32) on ``mesh``
    against make_train_step from the same weights and generator: the
    metrics and the gradients each step applied, normwise."""
    from davo_tpu_torch.parallel import make_dp_train_step
    from davo_tpu_torch.solve import BFGSConfig
    from davo_tpu_torch.train import CalibrationExperiment, create_train_state, make_train_step

    config = CalibrationExperiment(num_views=M, num_points=N, hidden_size=64, batch_size=64, warmup_steps=1,
                                   solver=BFGSConfig(iterations=3, training_iterations=3, line_search_iterations=8,
                                                     drop_path_p=0.1))
    out = []
    for make in (lambda state: make_dp_train_step(state, config, mesh), lambda state: make_train_step(state, config)):
        state = create_train_state(config, device, generator=torch.Generator().manual_seed(7))
        applied = {}
        apply = state.apply_gradients

        def recording_apply(gradients, apply=apply, applied=applied):
            applied["gradients"] = torch.cat([g.reshape(-1) for g in gradients]).clone()
            apply(gradients)

        state.apply_gradients = recording_apply
        metrics = make(state)(torch.Generator(device).manual_seed(8))
        out.append((metrics, applied["gradients"], torch.cat([b.reshape(-1) for b in state.network.buffers()
                                                              if b.is_floating_point()])))
    (metrics, grads, stats), (ref_metrics, ref_grads, ref_stats) = out
    tol = MULTIDEVICE_STEP_TOL
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        checks=dict(gradients=check("dp step gradients", grads, ref_grads, tol),
                    running_statistics=check("dp step running statistics", stats, ref_stats, tol),
                    **{k: check(f"dp step {k}", metrics[k], ref_metrics[k], tol) for k in ref_metrics}),
    )


def multidevice_phase(device):
    """The multi-device layer on a one-rank NCCL group (initialize_distributed
    at a localhost address, make_mesh on the card): distributed_schur_ba
    and distributed_schur_ba_2d (1 x 1) against schur_ba_solve on the card,
    distributed_stitch_windows against itself on a one-rank gloo group on
    the CPU, one make_dp_train_step step against make_train_step, and the
    collectives each issued (by wrapping dist.all_reduce and
    dist.all_gather)."""
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from davo_tpu_torch.parallel import (
        SchurConfig,
        distributed_schur_ba,
        distributed_schur_ba_2d,
        distributed_stitch_windows,
        initialize_distributed,
        make_mesh,
        schur_ba_solve,
    )

    recorded = []
    all_reduce, all_gather = dist.all_reduce, dist.all_gather

    def recording_all_reduce(tensor, *args, group=None, **kwargs):
        recorded.append(("all_reduce", dist.get_world_size(group), tensor.numel() * tensor.element_size()))
        return all_reduce(tensor, *args, group=group, **kwargs)

    def recording_all_gather(tensor_list, tensor, *args, group=None, **kwargs):
        recorded.append(("all_gather", dist.get_world_size(group), tensor.numel() * tensor.element_size()))
        return all_gather(tensor_list, tensor, *args, group=group, **kwargs)

    def collectives(fn):
        recorded.clear()
        dist.all_reduce, dist.all_gather = recording_all_reduce, recording_all_gather
        try:
            result = fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
        finally:
            dist.all_reduce, dist.all_gather = all_reduce, all_gather
        return result, list(recorded)

    with socket.socket() as sock:  # a free port on this machine's loopback
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    rank = initialize_distributed(f"127.0.0.1:{port}", 1, 0, device=device)
    out = dict(rank=rank, backend=dist.get_backend(), init_seconds=time.perf_counter() - t0)
    try:
        mesh = make_mesh(device=device)
        mesh_2d = init_device_mesh(device.type, (1, 1), mesh_dim_names=("kf", "pt"))
        problem, obs = multidevice_problem(device)
        config = SchurConfig(iterations=8, damping=1e-4)
        single = schur_ba_solve(problem, obs, config)
        for name, fn in (("schur_1d", lambda: distributed_schur_ba(problem, obs, mesh, config)),
                         ("schur_2d", lambda: distributed_schur_ba_2d(problem, obs, mesh_2d, config))):
            solved, issued = collectives(fn)
            out[name] = dict(collectives=issued, **{
                k: check(f"{name} {k}", getattr(solved, k), getattr(single, k), MULTIDEVICE_SOLVE_TOL)
                for k in ("intrinsics", "poses", "points")})
        starts, window_poses, frames = multidevice_windows(device)
        stitched, issued = collectives(lambda: distributed_stitch_windows(starts, window_poses, frames, mesh))
        cpu_mesh = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu", mesh_dim_names=("data",))
        on_cpu = distributed_stitch_windows(starts, [w.cpu() for w in window_poses], frames, cpu_mesh)
        out["stitch"] = dict(collectives=issued,
                             check=check("stitch card against CPU", stitched.cpu(), on_cpu, MULTIDEVICE_SOLVE_TOL))
        step, issued = collectives(lambda: multidevice_step(device, mesh))
        out["dp_step"] = dict(collectives=issued, **step)
    finally:
        dist.destroy_process_group()
    return out


# ------------------------------------------------- learned solvers ----


def jax_metrics_epoch(log, epoch=0):
    """The ``train`` record of ``epoch`` in one of the JAX runs' metrics
    files (JSON lines; the first may be the run's record)."""
    with open(os.path.join(REPO, "artifacts", log)) as f:
        for line in f:
            record = json.loads(line)
            if record.get("split") == "train" and record.get("epoch") == epoch:
                return record
    raise KeyError(f"no train record of epoch {epoch} in {log}")


def within_band(name, value, reference, band=LEARNED_SOLVER_BAND):
    if not (math.isfinite(value) and band[0] * reference <= value <= band[1] * reference):
        raise AssertionError(f"{name}: {value} is outside {band} x the JAX figure {reference}")
    return dict(value=value, jax=reference, ratio=value / reference)


def timed_comparison(device, network, config, batches):
    """compare_with_bfgs with K1's launches counted from 0 just before it."""
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import compare_with_bfgs

    torch.cuda.synchronize()
    build.reset_launch_counts()
    start = time.perf_counter()
    table = compare_with_bfgs(network, config, config.seed + 1, batches, device=device)
    torch.cuda.synchronize()
    return dict(table=table, batches=batches, scenes=batches * config.batch_size,
                seconds=time.perf_counter() - start, launches=dict(build.launch_counts))


def learned_solver_phase(device):
    """The trained MLP solver against BFGS (K1 at B = 256, P = 45) beside
    the JAX table; the logged epoch 0 of each solver type beside the JAX
    runs' (their recorded configs); the trained direction gate's
    comparison (K1 with direction_fn)."""
    import dataclasses

    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import fit_learned_solver, load_learned_solver

    network, config = load_learned_solver(LEARNED_SOLVER_CHECKPOINT, device=device)
    comparison = timed_comparison(device, network, config, LEARNED_SOLVER_BATCHES)
    jax_table = jax_reference(LEARNED_SOLVER_LOG)["comparison"]
    bands = {f"{row} objective": within_band(f"learned_solver {row} objective", comparison["table"][row]["objective"],
                                             jax_table[row]["objective"]) for row in jax_table}
    for row in ("bfgs_equal_budget", "bfgs_4x_budget"):
        bands[f"{row} basin_rate"] = within_band(f"learned_solver {row} basin_rate",
                                                 comparison["table"][row]["basin_rate"], jax_table[row]["basin_rate"])
    if not comparison["launches"]["bfgs_update"] > 0:
        raise AssertionError(f"learned_solver: K1 was never launched ({comparison['launches']})")
    comparison.update(bands=bands, jax_table=jax_table)

    training, trained = {}, {}
    for solver_type, (loss_mode, log) in LEARNED_SOLVER_RUNS.items():
        train_config = dataclasses.replace(config, solver_type=solver_type, loss_mode=loss_mode,
                                           **LEARNED_SOLVER_TRAIN)
        # the logged run's config but its 20 epochs (a constant rate: its
        # epoch 0 is this one-epoch run's)
        differences = config_differences(train_config, logged_run_config(os.path.join(REPO, "artifacts", log)),
                                         skip=("epochs",))
        if differences:
            raise AssertionError(f"learned_solver {solver_type}: the config differs from {log}'s: {differences}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        start = time.perf_counter()
        state, history = fit_learned_solver(train_config, device=device)
        trained[solver_type] = (state.network, train_config)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        row = history["train"][0]
        reference = jax_metrics_epoch(log)
        training[solver_type] = dict(
            loss_mode=loss_mode, final_error=row["final_error"], start_error=row["start_error"], loss=row["loss"],
            seconds_per_step=seconds / train_config.batches_per_epoch, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches=dict(build.launch_counts), jax_epoch0_final_error=reference["final_error"],
            jax_epoch0_start_error=reference["start_error"],
        )
        if not all(math.isfinite(row[k]) for k in ("final_error", "start_error", "loss")):
            raise AssertionError(f"learned_solver {solver_type}: not finite {row}")
        if any(build.launch_counts.values()):  # the training solves are differentiable: no kernel
            raise AssertionError(f"learned_solver {solver_type}: training launched {dict(build.launch_counts)}")
        training[solver_type]["band"] = within_band(f"learned_solver {solver_type} final_error",
                                                    row["final_error"], reference["final_error"])
    gated = timed_comparison(device, *trained["direction"], LEARNED_SOLVER_DIRECTION_BATCHES)
    if not gated["launches"]["bfgs_update"] > 0:
        raise AssertionError(f"learned_solver direction: K1 was never launched ({gated['launches']})")
    return dict(comparison=comparison, launches=comparison["launches"], training=training, direction=gated)


# ------------------------------------------------------------ gen-1 ----


def gen1_objective(batch=GEN1_SOLVE_SCENES, seed=8, device="cpu"):
    """``batch`` gen-1 objectives (E = 1, 4 views x 8 points) on generated
    scenes' observations, from a start of focal about 1, principal point
    0, cameras 5 units back and points 2 to 2.5 units ahead, drawn on the
    CPU and moved to ``device``."""
    from davo_tpu_torch.camera import PinholeBAConfig, PinholeBAData, PinholeBAParams, PinholeCameraModelL1
    from davo_tpu_torch.data import SceneConfig, generate_batch

    scenes = generate_batch(torch.Generator().manual_seed(seed), batch, SceneConfig(num_views=M, num_points=N),
                            device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    translation = 0.3 * torch.randn(batch, 1, M, 3, generator=g)
    translation[..., 2] += 5.0
    points = torch.cat([0.5 * torch.randn(batch, 1, N - 2, 2, generator=g),
                        2.0 + 0.5 * torch.rand(batch, 1, N - 2, 1, generator=g)], dim=-1)
    params = PinholeBAParams(
        focal_length=1.0 + 0.1 * torch.randn(batch, 1, generator=g), cx=torch.zeros(batch, 1),
        cy=torch.zeros(batch, 1), translation=translation, orientation=0.1 * torch.randn(batch, 1, M, 3, generator=g),
        world_points=points,
    )
    data = PinholeBAData(scenes.projected_points[:, None], scenes.visibility_mask[:, None])
    return PinholeCameraModelL1(PinholeBAParams(*(x.to(device) for x in params)),
                                PinholeBAData(*(x.to(device) for x in data)), PinholeBAConfig(constrain=True))


def gen1_protocol_solve(device):
    """bfgs_solve_function on GEN1_SOLVE_SCENES objectives on the card
    (launches counted from 0 just before it) and on the CPU: the share of
    solved parameter vectors that agree to 1e-3 normwise (a Wolfe decision
    that float32 rounding flips sends an element down another path), the
    share of objectives each lowers, the mean objective before and
    after."""
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.solve import bfgs_solve_function

    out = {}
    for dev in (device, torch.device("cpu")):
        model = gen1_objective(device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        build.reset_launch_counts()
        start = time.perf_counter()
        solved = bfgs_solve_function(model)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        before, after = model.get_error(), solved.get_error()
        out[dev.type] = dict(
            seconds=time.perf_counter() - start, launches=dict(build.launch_counts),
            mean_objective_start=float(before.mean()), mean_objective_solved=float(after.mean()),
            share_lowered=float((after <= before).float().mean()),
            vector=solved.as_parameters_vector().reshape(GEN1_SOLVE_SCENES, -1).cpu(),
        )
    card, cpu = out["cuda"].pop("vector"), out["cpu"].pop("vector")
    diff = (card - cpu).abs().amax(dim=1) / cpu.abs().amax(dim=1).clamp(min=1.0)
    return dict(scenes=GEN1_SOLVE_SCENES, p=GEN1_P, card=out["cuda"], cpu=out["cpu"],
                share_agreeing_1e3=float((diff <= 1e-3).float().mean()), launches=out["cuda"]["launches"])


def gen1_step_on(device, config, batch):
    """One gen-1 train step of ``config`` from its flax-style weights on
    ``batch``: the metrics and the gradients (on the CPU); no kernel may
    launch (the training solve is differentiable)."""
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import create_optimisation_state, make_optimisation_train_step
    from davo_tpu_torch.types import CameraViewsAndPoints

    state = create_optimisation_state(config, device)
    seen = {}
    apply = state.apply_gradients

    def recording_apply(gradients):
        seen["grads"] = [g.detach().cpu().double().clone() for g in gradients]  # apply clips in place
        apply(gradients)

    state.apply_gradients = recording_apply
    build.reset_launch_counts()
    moved = CameraViewsAndPoints(*(x.to(device, config.dtype) if x.is_floating_point() else x.to(device)
                                   for x in batch))
    metrics = make_optimisation_train_step(state, config)(batch=moved)
    if any(build.launch_counts.values()):
        raise AssertionError(f"gen1 train_check: the train step launched {dict(build.launch_counts)}")
    return {k: float(v) for k, v in metrics.items()}, seen["grads"]


def gen1_train_check(device):
    """One bfgs_solver_only_error_gradient train step (hidden 256, a
    5-iteration unrolled solve on the analytic gradient) on the card and
    on the CPU from the same flax-style weights and the same batch of
    GEN1_CHECK_BATCH scenes: the loss and metrics relative to themselves,
    the gradients normwise over the network (2-norm).  In float64 each
    within GEN1_CHECK_TOL; in float32 reported only: rounding flips the
    unrolled solve's line-search decisions (on the CPU alone, float32
    against float64 read 2.6e-4 on the loss and 1.3e-2 on the
    gradients)."""
    import dataclasses

    from davo_tpu_torch.data import generate_batch
    from davo_tpu_torch.train import get_preset

    config = dataclasses.replace(get_preset("bfgs_solver_only_error_gradient"), batch_size=GEN1_CHECK_BATCH)
    batch = generate_batch(torch.Generator().manual_seed(9), GEN1_CHECK_BATCH,
                           dataclasses.replace(config.resolved_scene(), dtype=torch.float64), device="cpu")
    out = {}
    for dtype in (torch.float64, torch.float32):
        typed = dataclasses.replace(config, dtype=dtype)
        (metrics, grads), (cpu_metrics, cpu_grads) = (gen1_step_on(dev, typed, batch)
                                                      for dev in (device, torch.device("cpu")))
        checks = {name: relative_error(metrics[name], value) for name, value in cpu_metrics.items()}
        err = math.sqrt(sum(float(torch.sum((a - b) ** 2)) for a, b in zip(grads, cpu_grads)))
        ref = math.sqrt(sum(float(torch.sum(b ** 2)) for b in cpu_grads))
        checks["gradients_normwise"] = err / ref
        out[str(dtype).replace("torch.", "")] = dict(checks=checks, loss_card=metrics["loss"],
                                                     loss_cpu=cpu_metrics["loss"], gradient_norm_cpu=ref)
    failed = {k: v for k, v in out["float64"]["checks"].items() if not v <= GEN1_CHECK_TOL}
    if failed:
        raise AssertionError(f"gen1 train_check: float64 beyond {GEN1_CHECK_TOL}: {failed}")
    return dict(batch=GEN1_CHECK_BATCH, tolerance_float64=GEN1_CHECK_TOL, **out)


def gen1_train_phase(device):
    """The card-against-CPU step, each gen-1 preset's steps at its own
    batch (losses finite, seconds a step, peak memory, no kernel), and the
    protocol solve (K1 at P = 44)."""
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.train import batch_generator, create_optimisation_state, get_preset
    from davo_tpu_torch.train import make_optimisation_train_step

    check = gen1_train_check(device)
    presets = {}
    for name, steps in GEN1_STEPS.items():
        config = get_preset(name)
        state = create_optimisation_state(config, device)
        train_step = make_optimisation_train_step(state, config)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        losses, seconds = [], []
        for i in range(steps):
            start = time.perf_counter()
            metrics = train_step(batch_generator(device, config.seed, 0, 0, i))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            losses.append(float(metrics["loss"]))
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"gen1 {name}: non-finite losses {losses}")
        if any(build.launch_counts.values()):
            raise AssertionError(f"gen1 {name}: the train steps launched {dict(build.launch_counts)}")
        hidden = config.hidden_size if config.hidden_size > 0 else 8 * config.num_views * config.num_points
        presets[name] = dict(steps=steps, batch=config.batch_size, hidden=hidden,
                             solver_iterations=config.solver.iterations if config.solver_enabled else 0,
                             losses=losses, first_step_s=seconds[0], median_step_s=sorted(seconds)[len(seconds) // 2],
                             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        del state, train_step
        torch.cuda.empty_cache()
    solve = gen1_protocol_solve(device)
    if not solve["launches"]["bfgs_update"] > 0:
        raise AssertionError(f"gen1 protocol solve: K1 was never launched ({solve['launches']})")
    if any(solve["cpu"]["launches"].values()):
        raise AssertionError(f"gen1 protocol solve: the CPU solve launched {solve['cpu']['launches']}")
    if not (solve["share_agreeing_1e3"] >= 0.9 and solve["card"]["mean_objective_solved"]
            < solve["card"]["mean_objective_start"]):
        raise AssertionError(f"gen1 protocol solve: card against CPU {solve}")
    return dict(train_check=check, presets=presets, protocol_solve=solve)


# ------------------------------------------------------ distortion ----


def distorted_draw(batch, dtype, seed=DISTORTED_SEED):
    """Scenes and perturbed starts as ``evaluate_distorted_calibration``
    draws them (32 points, perturbation 0.02, the translation's 5 times
    larger), from a CPU generator: the card and the CPU solve the same
    draws."""
    from davo_tpu_torch.camera import NUM_DISTORTED_PARAMS, DistortedSceneConfig, generate_distorted_scenes

    g = torch.Generator().manual_seed(seed)
    world, pixels, truth = generate_distorted_scenes(g, batch, DistortedSceneConfig(dtype=dtype), device="cpu")
    scale = torch.ones(NUM_DISTORTED_PARAMS, dtype=dtype)
    scale[13:16] = 5.0
    start = truth + 0.02 * scale * torch.randn(truth.shape, generator=g, dtype=dtype)
    return world, pixels, truth, start


def distorted_metrics(world, pixels, truth, start, refined):
    """``evaluate_distorted_calibration``'s four figures."""
    from davo_tpu_torch.camera import distorted_project

    err = (refined - truth).abs()
    return dict(
        max_param_error=float(err.max()), mean_param_error=float(err.mean()),
        rms_residual=float((distorted_project(world, refined) - pixels).square().mean().sqrt()),
        start_max_param_error=float((start - truth).abs().max()),
    )


def distorted_bench(device):
    """``refine_distorted`` at the JAX bench's size (4,096 scenes of 32
    points, 60 LM iterations, float32) on the CPU's draws: the four
    figures, the solve's seconds (after a 2-iteration warm-up) and seconds
    per LM iteration."""
    from davo_tpu_torch.camera import refine_distorted
    from davo_tpu_torch.solve.least_squares import LMConfig

    world, pixels, truth, start = (x.to(device) for x in distorted_draw(DISTORTED_BATCH, torch.float32))
    refine_distorted(world, pixels, start, LMConfig(iterations=2))
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    refined = refine_distorted(world, pixels, start, LMConfig(iterations=DISTORTED_ITERATIONS))
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(
        batch=DISTORTED_BATCH, points=world.shape[1], lm_iterations=DISTORTED_ITERATIONS,
        metrics=distorted_metrics(world, pixels, truth, start, refined), seconds_solve=seconds,
        seconds_per_lm_iteration=seconds / DISTORTED_ITERATIONS,
        lm_iterations_per_s=DISTORTED_BATCH * DISTORTED_ITERATIONS / seconds,
    )


def distorted_card_against_cpu(device):
    """One float64 draw of 16 scenes refined on the card and on the CPU
    (60 iterations): the refined parameters within 1e-9."""
    from davo_tpu_torch.camera import refine_distorted

    draw = distorted_draw(DISTORTED_CHECK_SCENES, torch.float64, seed=DISTORTED_SEED + 1)
    cpu = refine_distorted(*draw[:2], draw[3])
    card = refine_distorted(*(x.to(device) for x in (*draw[:2], draw[3]))).cpu()
    err = float((card - cpu).abs().max())
    if not err <= DISTORTED_CHECK_TOL:
        raise AssertionError(f"distorted: card against CPU {err} exceeds {DISTORTED_CHECK_TOL}")
    return dict(scenes=DISTORTED_CHECK_SCENES, max_abs_err=err, tolerance=DISTORTED_CHECK_TOL,
                max_param_error_card=float((card - draw[2]).abs().max()))


def distorted_jacobian_check(device):
    """The closed-form Jacobian against ``torch.func.jacfwd`` on the card,
    float32, at the bench's batch; each timed."""
    from davo_tpu_torch.camera import distorted_project_and_jacobian, distorted_project_and_jacobian_jacfwd

    world, _, _, start = (x.to(device) for x in distorted_draw(DISTORTED_BATCH, torch.float32))
    pix, jac = distorted_project_and_jacobian(world, start)
    pix_fwd, jac_fwd = distorted_project_and_jacobian_jacfwd(world, start)
    result = dict(jacobian=check("distorted jacobian", jac, jac_fwd, DISTORTED_JACOBIAN_TOL),
                  pixels=check("distorted pixels", pix, pix_fwd, DISTORTED_JACOBIAN_TOL))
    result["closed_form_ms"] = cuda_ms(lambda: distorted_project_and_jacobian(world, start), reps=20)
    result["jacfwd_ms"] = cuda_ms(lambda: distorted_project_and_jacobian_jacfwd(world, start), reps=5, warmup=1)
    return result


def distorted_phase(device):
    """``cli eval-distorted`` at its defaults and ``refine_distorted`` at
    the JAX bench's size on the card (no kernel: LM in plain PyTorch, TF32
    off), beside the JAX TPU log; the bench's float32 figures in the bands
    written from a CPU run of the same draws; the card against the CPU in
    float64; the closed-form Jacobian against jacfwd."""
    from davo_tpu_torch import cli

    t0 = time.perf_counter()
    cli_metrics = cli.run(["eval-distorted"])
    torch.cuda.synchronize()
    cli_seconds = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in cli_metrics.values()) or not cli_metrics["worst_max_param_error"] < 5e-3:
        raise AssertionError(f"distorted: eval-distorted {cli_metrics}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("distorted: TF32 is on in the LM's J^T J products")
    bench = distorted_bench(device)
    assert_within_bands("distorted bench", bench["metrics"], DISTORTED_BANDS)
    with open(DISTORTED_LOG) as f:
        jax_tpu = json.loads(next(line for line in f if line.startswith("{")))
    return dict(
        eval_distorted=dict(metrics=cli_metrics, seconds=cli_seconds,
                            seconds_per_lm_iteration=cli_seconds / (4 * DISTORTED_ITERATIONS)),
        bench=bench, bands=DISTORTED_BANDS, jax_tpu_log_for_comparison=jax_tpu,
        card_against_cpu=distorted_card_against_cpu(device), jacobian=distorted_jacobian_check(device),
    )


# ---------------------------------------------- sequential tracking ----


def track_inputs(device):
    """The front end of the vo_eval phase (frontend_v4, its gates) and
    TRACK_SEQUENCES of its 16-frame orbits of 8 points (sequence ``s`` as
    vo-eval's trial ``s`` draws it: a generator seeded 100 + s, the
    trajectory then its render at 96 px): images, true projections and
    their visibility."""
    from davo_tpu_torch.models import load_frontend
    from davo_tpu_torch.train.vo_eval import (
        TrajectoryConfig,
        draw_trajectory_noise,
        render_trajectory_images,
        trajectory_from_noise,
    )

    frontend, render = load_frontend(FRONTEND_NPZ, device=device, default_points=N, **TRACK_GATES)
    config = TrajectoryConfig(num_frames=TRACK_FRAMES, num_points=N)
    images, pixels, visibility = [], [], []
    for s in range(TRACK_SEQUENCES):
        g = torch.Generator(device).manual_seed(100 + s)
        _, _, px, vis = trajectory_from_noise(draw_trajectory_noise(g, config, device), config)
        images.append(render_trajectory_images(px, vis, g, render))
        pixels.append(px)
        visibility.append(vis)
    return frontend, torch.stack(images), torch.stack(pixels), torch.stack(visibility)


def identity_curve(matches, match_visibility, pixels, visibility):
    """Per frame, the share of the tracks seen there whose point lies
    nearest to the true projection of the world point their frame-0 point
    lies nearest to (nearest among the points visible in the frame)."""
    d2 = (matches[:, :, :, None, :] - pixels[:, :, None, :, :]).square().sum(-1)  # (S, F, N, P)
    nearest = torch.where(visibility[:, :, None, :], d2, float("inf")).argmin(-1)  # (S, F, N)
    seen = match_visibility > 0
    same = (nearest == nearest[:, :1]) & seen
    return [float(x) for x in same.sum((0, 2)) / seen.sum((0, 2)).clamp(min=1)], \
        [float(x) for x in seen.float().mean((0, 2))]


def track_k3(device):
    """K3 at the tracking shape (TRACK_SEQUENCES problems of N track
    queries against 144 cells, and 32 queries) against its plain version;
    its time, the plain version's, SDPA's and its bound."""
    from davo_tpu_torch.ops.attention import flash_match_attention, reference_flash_attention

    checks = {}
    for q_len in (N, 32):
        q, k, v, _ = k3_inputs(TRACK_SEQUENCES, q_len, K3_CELLS, K3_DEPTH, K3_WIDTH, device, seed=q_len, masked=False)
        got = flash_match_attention(q, k, v)
        torch.cuda.synchronize()
        checks[f"q{q_len}"] = check(f"K3 tracking q={q_len}", got, reference_flash_attention(q, k, v), 1e-5)
    b, ql, kl, d, c = TRACK_SEQUENCES, N, K3_CELLS, K3_DEPTH, K3_WIDTH
    q, k, v, _ = k3_inputs(b, ql, kl, d, c, device, seed=11, masked=False)
    bound_ms, bound_by, _ = k3_bound(b, ql, kl, d, c)
    library = sdpa_ms(q, k, v, reference_flash_attention(q, k, v))
    if library["library_ms"] is not None:
        # at 4 problems both calls are the host's enqueue: the card's own
        # time of each, from a CUDA graph, beside it
        from torch.nn.attention import SDPBackend, sdpa_kernel

        v4 = torch.nn.functional.pad(v, (0, library["library_value_width"] - c))[:, None].contiguous()
        with sdpa_kernel([getattr(SDPBackend, library["library_backend"])]):
            library["library_graph_ms"] = graph_replay_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(q[:, None], k[:, None], v4), reps=50)
    return dict(
        problems=b, queries=ql, keys=kl, depth=d, width=c, checks=checks,
        max_abs_err=max(x["max_abs_err"] for x in checks.values()),
        ms=cuda_ms(lambda: flash_match_attention(q, k, v), reps=50),
        graph_ms=graph_replay_ms(lambda: flash_match_attention(q, k, v), reps=50),
        plain_ms=cuda_ms(lambda: reference_flash_attention(q, k, v), reps=20),
        bound_ms=bound_ms, bound_by=bound_by, **library,
    )


def track_sequence_phase(device):
    """Sequential tracking (``VOFrontend(track_sequence=True)``) on the
    vo_eval phase's orbits, launches counted from 0 just before it (K3
    once a frame after the first), and the anchor path (every frame
    matched to frame 0, one window of 16 views) on the same frames, apart:
    each one's identity curve; then K3 at the tracking shape."""
    from davo_tpu_torch.ops import build

    frontend, images, pixels, visibility = track_inputs(device)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    tracked = frontend(images, track_sequence=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    if launches.get("match_attention", 0) != TRACK_FRAMES - 1:
        raise AssertionError(f"track_sequence: K3 launched {launches} times, not once a frame after the first")
    if tuple(tracked.matches.shape) != (TRACK_SEQUENCES, TRACK_FRAMES, N, 2) or not torch.isfinite(
            tracked.matches).all():
        raise AssertionError(f"track_sequence: bad matches {tuple(tracked.matches.shape)}")
    anchor = frontend(images)
    torch.cuda.synchronize()
    identity, seen = identity_curve(tracked.matches, tracked.match_visibility, pixels, visibility)
    identity_anchor, seen_anchor = identity_curve(anchor.matches, anchor.match_visibility, pixels, visibility)
    return dict(
        sequences=TRACK_SEQUENCES, frames=TRACK_FRAMES, tracks=N, gates=TRACK_GATES, seconds_tracking=seconds,
        launches=launches, identity_share_tracking=identity, seen_share_tracking=seen,
        identity_share_anchor=identity_anchor, seen_share_anchor=seen_anchor, k3=track_k3(device),
    )


# --------------------------------------------------- infrastructure ----


def _cli_lines(argv):
    """``cli.main(argv)``'s exit code and printed lines."""
    import contextlib
    import io

    from davo_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(argv)
    return code, out.getvalue().strip().splitlines()


def infra_phase(device):
    """``fit --config`` (mlp_guess_config.yaml cut to 1 epoch of 2 batches)
    registering its run in a temporary registry, ``runs list|show|compare``
    reading it back; ``presets``; a ``profiling.trace`` around one served
    BFGS iteration (K1 and K2 named in its Chrome trace); the served
    network's ``weight_summaries``."""
    from davo_tpu_torch.data import SceneConfig, generate_batch
    from davo_tpu_torch.models.convert import state_dict_to_flax
    from davo_tpu_torch.train import weight_summaries
    from davo_tpu_torch.utils import trace

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        registry = os.path.join(tmp, "runs")
        argv = ["fit", "--config", INFRA_CONFIG, "--epochs", "1", "--batches-per-epoch", "2", "--registry-dir",
                registry, "--metrics-file", os.path.join(tmp, "m.jsonl"), "--checkpoint-dir", os.path.join(tmp, "ck"),
                "--tensorboard-dir", os.path.join(tmp, "tb")]
        t0 = time.perf_counter()
        code, lines = _cli_lines(argv)
        out["fit_seconds"] = time.perf_counter() - t0
        run = json.loads(lines[0])
        if code != 0 or "final_train" not in json.loads(lines[-1]):
            raise AssertionError(f"infra: fit --config failed ({code}): {lines[-3:]}")
        out["fit"] = dict(run=run, final=json.loads(lines[-1]))
        code, listed = _cli_lines(["runs", "list", "--registry-dir", registry])
        listed = [json.loads(line) for line in listed]
        code_show, shown = _cli_lines(["runs", "show", run["run_id"], "--registry-dir", registry])
        shown = json.loads("\n".join(shown))
        code_compare, compared = _cli_lines(["runs", "compare", "--registry-dir", registry, "--split", "train"])
        compared = json.loads("\n".join(compared))
        if (code, code_show, code_compare) != (0, 0, 0) or [r["run_id"] for r in listed] != [run["run_id"]] \
                or shown["final_metrics"]["train"]["loss"] != out["fit"]["final"]["final_train"]["loss"] \
                or set(compared["metrics"]["loss"]) != {run["run_id"]} or listed[0]["backend"] != "cuda":
            raise AssertionError(f"infra: the registry did not read back: {listed} {shown} {compared}")
        out["runs"] = dict(list=listed, show_final_metrics=shown["final_metrics"], compare=compared)
        out["tensorboard_files"] = os.listdir(os.path.join(tmp, "tb"))
        if not any(name.startswith("events.out.tfevents.") for name in out["tensorboard_files"]):
            raise AssertionError(f"infra: no TensorBoard event file ({out['tensorboard_files']})")
        code, presets = _cli_lines(["presets"])
        if code != 0 or [line.split(":")[0] for line in presets] != JAX_PRESETS:
            raise AssertionError(f"infra: presets {presets}")
        out["presets"] = presets

        network = serve_network(device, iterations=1)
        scenes = generate_batch(torch.Generator(device).manual_seed(9), SERVE_SCENES, SceneConfig(), device=device)
        network(scenes.projected_points, scenes.visibility_mask)  # warm-up
        trace_dir = os.path.join(tmp, "trace")
        with trace(trace_dir):
            network(scenes.projected_points, scenes.visibility_mask)
        with open(os.path.join(trace_dir, "trace.json")) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
        kernels = sorted(n for n in names if "bfgs_update" in n or "calibration_vg" in n)
        if not any("bfgs_update" in n for n in kernels) or not any("calibration_vg" in n for n in kernels):
            raise AssertionError(f"infra: the trace names no K1 or K2 kernel ({sorted(names)[:20]})")
        out["trace"] = dict(kernels=kernels, kernel_names=len(names))
    summaries = weight_summaries(state_dict_to_flax(network.state_dict(), num_heads=8)[0])
    if not all(math.isfinite(v) for s in summaries.values() for v in s.values()):
        raise AssertionError("infra: weight summaries not finite")
    out["weight_summaries"] = dict(leaves=len(summaries), first=dict(list(summaries.items())[:3]))
    return out


def start_side_phase(names):
    """The phases ``names``, one after another, in a process of their own
    (``python3 chip_smoke.py --phase <name,name>``), on the same card,
    with the library this process built; its output goes to temporary
    files (a pipe left unread would stall it)."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase", ",".join(names)], cwd=REPO,
                            stdout=out, stderr=err, text=True)
    return proc, out, err


def side_phase_result(name, side):
    """``name``'s result from the side process of its group
    (``side["processes"]``, by group), waited for at the group's first
    reading; the process's result is its last line, ``{name: result}``,
    and a phase that raised there raises here with its traceback."""
    results = side.setdefault("results", {})
    if name not in results:
        group = next(g for g in SIDE_PROCESSES if name in g)
        proc, out, err = side["processes"].pop(group)
        with out, err:
            proc.wait()
            out.seek(0)
            err.seek(0)
            lines = out.read().strip().splitlines()
            try:
                read = json.loads(lines[-1])
            except (IndexError, ValueError):
                read = None
            if not isinstance(read, dict) or not set(group) <= set(read):
                raise AssertionError(f"side phases {group}: their process exited {proc.returncode}: "
                                     f"{err.read()[-3000:]}")
        results.update(read)
    result = results[name]
    if "error" in result:
        raise AssertionError(f"side phase {name} failed: {result['error']}")
    return result


def run_phases(device, smi, paths, side):
    """The paths after the kernel checks and the serving, each emitted as
    it ends.  The SIDE_PROCESSES groups (vo_eval's trial alone is 255-370
    s of host-bound solves, PERF.md section 5) run in two processes of
    their own from eval_v4 on, beside phases that time no kernel (the
    kernel checks and the fused-objective and tuning scripts run before
    they start), so the run fits its time limit without cutting a path's
    depth; their launches are counted in their own processes."""
    phases = [
        ("fused_objective", lambda: fused_objective_phase(device)),
        ("k1_tune", lambda: k1_tune_phase(device)),
        ("eval_v4", lambda: eval_v4_phase(device)),
        ("eval_restarts", lambda: eval_restarts_phase(device)),
        ("train_check", lambda: train_check_phase(device)),
        ("train", lambda: train_phase(device)),
        ("eval_lbfgs", lambda: eval_lbfgs_phase(device)),
        ("frontend_train_check", lambda: frontend_train_check_phase(device)),
        ("frontend_train", lambda: frontend_train_phase(device)),
        *((name, lambda name=name: side_phase_result(name, side)) for name in SIDE_PHASES),
        ("gen1_train", lambda: gen1_train_phase(device)),
        ("distorted", lambda: distorted_phase(device)),
        ("track_sequence", lambda: track_sequence_phase(device)),
        ("infra", lambda: infra_phase(device)),
        ("multidevice", lambda: multidevice_phase(device)),
    ]
    for label, fn in phases:
        if label == "eval_v4":
            side["processes"] = {group: start_side_phase(group) for group in SIDE_PROCESSES}
        t0 = time.perf_counter()
        paths[label] = fn()
        emit(label, card=smi, **paths[label], seconds=time.perf_counter() - t0)
        torch.cuda.empty_cache()


def run_side_phase(names):
    """``--phase <name,name>``: these phases alone on the card, one after
    another; ``{name: result}`` as the last line of standard output, a
    phase that raised as ``{"error": traceback}`` (the next still runs)
    and the exit code 1."""
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from davo_tpu_torch.ops import build
    from davo_tpu_torch.utils.precision import full_f32_matmuls

    device = torch.device("cuda")
    full_f32_matmuls()
    build.load_library()
    results = {}
    for name in names.split(","):
        t0 = time.perf_counter()
        try:
            results[name] = globals()[f"{name}_phase"](device)
        except Exception:
            results[name] = {"error": traceback.format_exc()[-3000:]}
            torch.cuda.empty_cache()
        results[name]["seconds_in_its_process"] = time.perf_counter() - t0
    print(json.dumps(results), flush=True)
    return int(any("error" in r for r in results.values()))


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
        ("k1_vo_f32", lambda: k1_phase(VO_BATCH, torch.float32, device)),
        ("k1_vo_windows_f32", lambda: k1_phase(VO_WINDOWS_BATCH, torch.float32, device)),
        ("k1_vo_drift_f32", lambda: k1_phase(VO_DRIFT_BATCH, torch.float32, device, p=VO_DRIFT_P)),
        ("k1_learned_solver", lambda: k1_phase(256, torch.float32, device)),
        ("k1_gen1", lambda: k1_phase(GEN1_SOLVE_SCENES, torch.float32, device, p=GEN1_P)),
        ("k1_eval_seq_p117", lambda: k1_phase(EVAL_SEQ_WINDOWS, torch.float32, device, p=EVAL_SEQ_P)),
        ("k1_eval_f32", lambda: k1_phase(V5_EVAL_BATCH * 8, torch.float32, device)),
        ("k2_serve", lambda: k2_phase(SERVE_SCENES * SERVE_RESTARTS, device)),
        ("k2_bench", lambda: k2_phase(BENCH_BATCH, device)),
        ("k2_val", lambda: k2_phase(VAL_BATCH, device)),
        ("k2_vo", lambda: k2_phase(VO_BATCH, device)),
        ("k2_vo_windows", lambda: k2_phase(VO_WINDOWS_BATCH, device)),
        ("k2_eval", lambda: k2_phase(V5_EVAL_BATCH * 8, device)),
        ("k3", lambda: k3_phase(device)),
        ("k4_bench", lambda: k4_phase(BENCH_BATCH, device)),
        ("k4_serve", lambda: k4_phase(SERVE_SCENES * SERVE_RESTARTS, device)),
        ("k2_eval_seq_4x32", lambda: k2_phase(EVAL_SEQ_WINDOWS, device, 4, EVAL_SEQ_POINTS)),
        ("k4_eval_seq_4x32", lambda: k4_phase(EVAL_SEQ_WINDOWS, device, 4, EVAL_SEQ_POINTS)),
        *((f"k{k}_{m}x{n}", lambda k=k, m=m, n=n: (k2_phase if k == 2 else k4_phase)(SERVE_SCENES * SERVE_RESTARTS,
                                                                                     device, m, n))
          for m, n in GENERAL_SCENES for k in (2, 4)),
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
    side = {}
    try:
        run_phases(device, smi, paths, side)
    finally:
        for proc, out, err in side.get("processes", {}).values():  # left running by a phase that raised
            proc.kill()
            proc.wait()
            out.close()
            err.close()
    paths["vo_windows_scale_drift"] = paths["vo_windows"]["scale_drift"]
    paths["vo_windows_learned"] = paths["vo_windows"]["learned_matches"]
    paths["eval_seq_learned"] = paths["eval_seq"]["learned"]
    paths["eval_seq_learned_32"] = paths["eval_seq"]["learned_32"]
    paths["learned_solver_direction"] = paths["learned_solver"]["direction"]
    paths["gen1_protocol_solve"] = paths["gen1_train"]["protocol_solve"]
    for name in ("frontend_v2", "frontend_v3", "v5_eval"):
        paths[f"orbax_{name}"] = paths["orbax"][name]
    for name in ("eval", "frontend"):
        paths[f"orbax_write_{name}"] = paths["orbax_write"][name]

    # launches: each kernel's count on the path that drives it, counted
    # from 0 just before the path and read just after: K1-K3 on the
    # learned-match window requests (without their comparison), K4 on the
    # fused-objective entry points, K1' on the tuning sweep; beside it, its
    # count on every path that launched it (K2 on the L-BFGS eval, K3 in
    # the front end's validation, K1-K3 on the vo-eval trial)
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
    sys.exit(run_side_phase(sys.argv[2]) if sys.argv[1:2] == ["--phase"] else main())
