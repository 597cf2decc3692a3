"""The JAX CLI's default ``vo-eval`` (the windows pipeline: oracle matches,
global stitch, refinement) at v3_1200, the JAX package and the port on the
JAX package's own draws (slow tier, float32 as the CLI runs).

    python -m pytest tests/test_torch_vo_windows_same_draw.py --runslow -s -o addopts=

For each of the CLI's three trial keys (``jax.random.key(100 + t)``) both
packages run ``vo-eval --checkpoint vo_windows_transformer_v3_1200.pkl
--hidden-size 384 --transformer-layers 8 --transformer-heads 8`` (8
restarts of the curriculum eval solver in each of the 7 windows of 4 over
16 frames): the JAX package from its own draws, its eval objective its
Pallas kernel's function (the polynomial atan2, as on the TPU and in the
port's K2); the port from the same sequence draws and the JAX network's
fixed restart noise.  ``artifacts/eval_v3_vo.log`` (refined) and
``eval_v3_vo_raw.log`` (``--no-refine``) are these runs on the TPU.

It prints one JSON line a trial: each stage's largest difference between
the packages in the order the pipeline runs them (the observations; each
window's guess-and-solve, one network call in either package; the same
solves in float64 on the JAX package's window inputs, cut to
SOLVE64_ITERATIONS iterations and whole, the whole ones beside the JAX
package against itself on inputs scaled by ``1 + 1e-15 N(0, 1)``; the stitched
trajectory, as rotation matrices and translations; the stitch of the JAX
package's window solves by the port; the refined trajectory and the port's
refinement of the JAX package's stitch), the raw (stitched) and refined
ATE rmse of each, and the first stage that parts by more than AGREE; last
the means.  The observations are asserted equal to OBS_TOL and the cut
float64 window solves to SOLVE64_TOL; over the 100 iterations rounding
grows through the solves' line searches (in float64 too, JAX against
itself alike), so the later stages are asserted finite and reported, as
the incremental check does.
"""

import dataclasses
import functools
import json
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CHECKPOINT = REPO / "artifacts" / "vo_windows_transformer_v3_1200.pkl"
TRIALS, AGREE, OBS_TOL = 3, 1e-3, 1e-5
SOLVE64_ITERATIONS, SOLVE64_TOL, PERTURBATION = 10, 1e-9, 1e-15


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def _pose_diff(a, b):
    """Poses ``(K, 6)`` compared as rotation matrices and translations."""
    from davo_tpu_torch.geometry import so3_rotation_matrix

    a, b = torch.tensor(np.asarray(a, np.float64)), torch.tensor(np.asarray(b, np.float64))
    return max(_diff(so3_rotation_matrix(a[:, :3]), so3_rotation_matrix(b[:, :3])), _diff(a[:, 3:], b[:, 3:]))


def _ate(estimates, true_poses):
    """The similarity-aligned ATE rmse of camera centres (the port's
    functions, float64, for either package's poses)."""
    from davo_tpu_torch.train.vo_eval import absolute_trajectory_error, camera_centers_from_poses

    est, true = (torch.tensor(np.asarray(x, np.float64)) for x in (estimates, true_poses))
    centres = [camera_centers_from_poses(p[:, 0:3], p[:, 3:6]) for p in (est, true)]
    return float(absolute_trajectory_error(*centres)["rmse"])


def _jax_guess_fn(monkeypatch, dtype=jnp.float32, solver=None):
    import davo_tpu.models.calibration_network as j_network_module
    from davo_tpu.train import get_preset
    from tests.test_torch_calibration_network import _kernel_function_objective

    monkeypatch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
    cfg = dataclasses.replace(
        get_preset("calibration_transformer_curriculum"), num_views=4, num_points=8, num_restarts=8,
        hidden_size=384, transformer_layers=8, transformer_heads=8,
    )
    if solver is not None:
        cfg = dataclasses.replace(cfg, solver=solver)
    net = dataclasses.replace(cfg.build_network(), fused_objective=True)
    with open(CHECKPOINT, "rb") as f:
        restored = pickle.load(f)
    variables = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), {
        "params": restored["params"], "batch_stats": restored.get("batch_stats", {})})
    return jax.jit(lambda pw, vw: net.apply(variables, pw, vw))


def _float64_solvers(monkeypatch, iterations):
    """``solve(inputs, visibility, perturbation=0.0)``: each package's
    window network in float64 with the eval solve cut to ``iterations``
    (the JAX package's under x64, its weights and restart draws in
    float64), on the JAX package's window inputs; with ``perturbation``
    the JAX package's alone, on its inputs scaled by ``1 + perturbation
    N(0, 1)``."""
    from davo_tpu.train import get_preset as j_get_preset
    from davo_tpu_torch import cli
    from davo_tpu_torch.train import get_preset

    with jax.enable_x64(True):
        solver = dataclasses.replace(j_get_preset("calibration_transformer_curriculum").solver, iterations=iterations)
        j_guess = _jax_guess_fn(monkeypatch, jnp.float64, solver=solver)
        draws = torch.tensor(np.asarray(jax.random.normal(jax.random.key(0), (1, 7, 45), jnp.float64)))
    args = cli._build_parser().parse_args([
        "vo-eval", "--platform", "cpu", "--checkpoint", str(CHECKPOINT), "--hidden-size", "384",
        "--transformer-layers", "8", "--transformer-heads", "8",
    ])
    solver = dataclasses.replace(get_preset("calibration_transformer_curriculum").solver, iterations=iterations)
    net = cli._guess_network(args, torch.device("cpu"), selection=args.selection,
                             basin_anchor_weight=args.basin_anchor, solver=solver).double()
    port_guess = functools.partial(cli._guess_fn(net), restart_draws=draws)
    rng = np.random.default_rng(0)

    def solve(inputs, visibility, perturbation=0.0):
        inputs, visibility = np.asarray(inputs, np.float64), np.asarray(visibility, np.float64)
        if perturbation:
            inputs = inputs * (1 + perturbation * rng.standard_normal(inputs.shape))
        with jax.enable_x64(True):
            j_out = np.concatenate([np.asarray(j_guess(jnp.asarray(p)[None], jnp.asarray(v)[None]))
                                    for p, v in zip(inputs, visibility)])
        if perturbation:
            return j_out
        with torch.no_grad():
            out = port_guess(torch.tensor(inputs), torch.tensor(visibility))
        return j_out, out.numpy()

    return solve


def _port_setup():
    from davo_tpu_torch import cli

    args = cli._build_parser().parse_args([
        "vo-eval", "--platform", "cpu", "--checkpoint", str(CHECKPOINT), "--hidden-size", "384",
        "--transformer-layers", "8", "--transformer-heads", "8",
    ])
    config, kwargs = cli.vo_eval_setup(args, torch.device("cpu"))
    draws = torch.tensor(np.asarray(jax.random.normal(jax.random.key(0), (1, 7, 45), jnp.float32)))
    kwargs["guess_fn"] = functools.partial(kwargs["guess_fn"], restart_draws=draws)
    return config, kwargs


@pytest.mark.slow
def test_windows_pipeline_same_draws(monkeypatch):
    from davo_tpu.train import vo_eval as J
    from davo_tpu_torch.train import vo_eval as T
    from tests.test_torch_vo_incremental import _jax_trajectory_draws

    torch.set_num_threads(8)
    rows = []
    with jax.enable_x64(False):
        j_guess = _jax_guess_fn(monkeypatch)
        config, kwargs = _port_setup()
        assert kwargs["refine"] and kwargs["pipeline"] == "windows" and kwargs["stitch"] == "global"
        j_log, t_log = dict(guess=[]), dict(guess=[])

        def recorded(fn, log):
            def wrapped(pw, vw):
                out = fn(pw, vw)
                log["guess"].append((_numpy(pw), _numpy(vw), _numpy(out)))
                return out

            return wrapped

        def recording(name, fn):
            def wrapped(*args, **kw):
                out = fn(*args, **kw)
                j_log[name] = [_numpy(x) for x in (out if isinstance(out, tuple) else (out,))]
                return out

            return wrapped

        monkeypatch.setattr(J, "generate_trajectory", recording("trajectory", J.generate_trajectory))
        monkeypatch.setattr(J, "solve_windowed_vo_learned", recording("stitched", J.solve_windowed_vo_learned))
        port_guess = kwargs.pop("guess_fn")
        solve_cut, solve_float64 = (_float64_solvers(monkeypatch, n) for n in (SOLVE64_ITERATIONS, 100))
        j_cfg = J.TrajectoryConfig(num_frames=16, num_points=8, window=4)
        for trial in range(TRIALS):
            j_log["guess"].clear()
            t_log["guess"].clear()
            key = jax.random.key(100 + trial)
            j_ate = J.evaluate_learned_vo(recorded(j_guess, j_log), key, j_cfg, refine=True)
            debug = {}
            t_ate = T.evaluate_learned_vo(recorded(port_guess, t_log), None, config, debug_out=debug,
                                          noise=dict(trajectory=_jax_trajectory_draws(key, j_cfg)), **kwargs)
            true_poses, _, pixels, visibility = j_log["trajectory"]
            stages = [("observations", max(_diff(pixels, debug["pixels"]), _diff(visibility, debug["visibility"]))),
                      ("true poses", _pose_diff(true_poses, debug["true_poses"]))]
            (_, _, t_vecs), = t_log["guess"]
            j_vecs = np.concatenate([out for _, _, out in j_log["guess"]])
            j_inputs = np.concatenate([pw for pw, _, _ in j_log["guess"]])
            stages.append(("window inputs", _diff(j_inputs, t_log["guess"][0][0])))
            for w, s in enumerate(debug["window_starts"]):
                stages.append((f"window {s} guess and solve", _diff(j_vecs[w], t_vecs[w])))
            # the same window solves in float64 on the JAX inputs: cut to
            # SOLVE64_ITERATIONS; whole, beside JAX against itself on inputs
            # perturbed by PERTURBATION
            j_vis = np.concatenate([vw for _, vw, _ in j_log["guess"]])
            (j_cut, t_cut), (j64, t64) = solve_cut(j_inputs, j_vis), solve_float64(j_inputs, j_vis)
            j_perturbed = solve_float64(j_inputs, j_vis, PERTURBATION)
            for w, s in enumerate(debug["window_starts"]):
                stages.append((f"window {s} guess and solve, float64, {SOLVE64_ITERATIONS} iterations",
                               _diff(j_cut[w], t_cut[w])))
            for w, s in enumerate(debug["window_starts"]):
                stages.append((f"window {s} guess and solve, float64", _diff(j64[w], t64[w])))
                stages.append((f"window {s} guess and solve, float64, JAX against JAX perturbed",
                               _diff(j64[w], j_perturbed[w])))
            (j_stitched,) = j_log["stitched"]
            stages.append(("stitched", _pose_diff(j_stitched, debug["stitched"])))
            # the port's stitch of the JAX package's window solves
            t_pixels, t_vis = debug["pixels"], debug["visibility"]
            starts, poses = T.solve_learned_windows(lambda *_: torch.tensor(j_vecs), t_pixels, t_vis, config)
            port_stitch = T.stitch_windows(starts, poses, t_pixels.shape[0], "global")
            stages.append(("port stitch of the JAX windows", _pose_diff(j_stitched, port_stitch)))
            port_refined = T.refine_trajectory_global(torch.tensor(j_stitched), debug["intrinsics"], t_pixels, t_vis,
                                                      rounds=kwargs["refine_rounds"])
            row = dict(
                trial=trial, jax_raw_rmse=_ate(j_stitched, true_poses), port_raw_rmse=_ate(debug["stitched"],
                                                                                           debug["true_poses"]),
                jax_refined_rmse=float(j_ate["rmse"]), port_refined_rmse=float(t_ate["rmse"]),
                port_refinement_of_jax_stitch_rmse=_ate(port_refined, true_poses),
                port_stitch_of_jax_windows_raw_rmse=_ate(port_stitch, true_poses),
            )
            row["first_stage_apart"] = next((name for name, d in stages if d > AGREE), None)
            row["stages"] = dict(stages)
            rows.append(row)
            print(json.dumps(row), flush=True)
            assert row["stages"]["observations"] <= OBS_TOL and row["stages"]["true poses"] <= OBS_TOL
            assert all(d <= SOLVE64_TOL for name, d in stages if name.endswith(f"{SOLVE64_ITERATIONS} iterations"))
    means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0] if k.endswith("rmse")}
    print(json.dumps({"trials": TRIALS, "means": means}), flush=True)
    assert all(np.isfinite(list(r[k] for k in means)).all() for r in rows)
