"""The official learned-VO recipe at full width on the CPU, the JAX package
and the port fed the same JAX-drawn sequences (slow tier: about 10
minutes on 8 cores).

    python -m pytest tests/test_torch_vo_same_draw.py --runslow -s -o addopts=

For each of the JAX CLI's four trial keys (``jax.random.key(100 + t)``)
both packages run ``vo-eval --pipeline incremental --association
geometric --no-refine --matches learned`` with
``vo_windows_transformer_v6_verified.pkl`` (embed 384, 8 layers, 8 heads,
8 restarts), the front end ``frontend_v4`` at 96 px with the official
gates, and ``--ba-irls 2``, in float32: the JAX package from its own
draws and its Orbax front-end checkpoint, the port from the same draws
(sequence, render, and the JAX network's fixed restart noise) and its
``frontend_v4.npz``.  The JAX side's eval objective is its Pallas
kernel's function (the polynomial atan2), as on the TPU and in the
port's K2.  The accumulator is chaotic with respect to arithmetic, so
trials may part; the test prints one JSON line a trial: both ATE rmse and
their difference, and each stage's largest difference between the
packages, in the order the pipeline runs them (the render, the front
end's whole-sequence detections, and for each bootstrap window its fresh
window matches, each guess call's output, the bootstrap the chain starts
from, and the chain's poses and cost; poses as rotation matrices and
translations), with the first stage that parts by more than 1e-3.
Each chain is also run in the port from the JAX package's own inputs to
it (``port_chain_on_jax_inputs``), which tells a difference the
accumulator makes from one it was handed.  Last, the number of trials
that agree to 1e-3.  It asserts only that both packages
finish every trial with a finite ATE.
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
CHECKPOINT = REPO / "artifacts" / "vo_windows_transformer_v6_verified.pkl"
FRONTEND_ORBAX = REPO / "artifacts" / "ckpt_frontend_v4"
FRONTEND_NPZ = REPO / "davo_tpu_torch" / "weights" / "frontend_v4.npz"
GATES = dict(nms_radius=0.1, snap_radius=0.12, cycle_threshold=0.15, quality_bonus=10.0, score_threshold=0.2)
TRIALS, AGREE = 4, 1e-3


def _jax_pipeline(monkeypatch):
    """The JAX CLI's vo-eval objects for the official recipe (davo_tpu/cli.py),
    with the eval objective of the TPU kernel."""
    import davo_tpu.models.calibration_network as j_network_module
    from davo_tpu.data.rendering import RenderConfig
    from davo_tpu.models import VOFrontend
    from davo_tpu.train import get_preset, restore_checkpoint
    from tests.test_torch_calibration_network import _kernel_function_objective

    monkeypatch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
    cfg = dataclasses.replace(
        get_preset("calibration_transformer_curriculum"), num_views=4, num_points=8, num_restarts=8,
        hidden_size=384, transformer_layers=8, transformer_heads=8,
    )
    net = dataclasses.replace(cfg.build_network(), fused_objective=True)
    with open(CHECKPOINT, "rb") as f:
        restored = pickle.load(f)
    variables = {"params": restored["params"], "batch_stats": restored.get("batch_stats", {})}
    frontend = VOFrontend(num_select=8, descriptor_channels=64, embedding_size=64, centroid_refine_iters=2, **GATES)
    fe = restore_checkpoint(str(FRONTEND_ORBAX))
    fe_vars = {"params": fe["params"], "batch_stats": fe.get("batch_stats", {})}

    @jax.jit
    def frontend_fn(images):
        out = frontend.apply(fe_vars, images)
        return out.matches, out.match_visibility

    @jax.jit
    def detections_fn(images):
        out = frontend.apply(fe_vars, images)
        return out.points, jax.nn.sigmoid(out.scores)

    return dict(guess_fn=jax.jit(lambda pw, vw: net.apply(variables, pw, vw)), frontend_fn=frontend_fn,
                detections_fn=detections_fn, render_config=RenderConfig(image_size=96))


def _port_pipeline():
    from davo_tpu_torch import cli

    args = cli._build_parser().parse_args([
        "vo-eval", "--platform", "cpu", "--checkpoint", str(CHECKPOINT), "--hidden-size", "384",
        "--transformer-layers", "8", "--transformer-heads", "8", "--pipeline", "incremental",
        "--association", "geometric", "--no-refine", "--matches", "learned", "--frontend-checkpoint",
        str(FRONTEND_NPZ), "--nms-radius", "0.1", "--snap-radius", "0.12", "--cycle-threshold", "0.15",
        "--quality-bonus", "10.0", "--score-threshold", "0.2", "--centroid-refine", "2", "--ba-irls", "2",
    ])
    config, kwargs = cli.vo_eval_setup(args, torch.device("cpu"))
    # the JAX network's fixed restart noise (no "restarts" rng): normal(key(0))
    draws = torch.tensor(np.asarray(jax.random.normal(jax.random.key(0), (1, 7, 45), jnp.float32)))
    kwargs["guess_fn"] = functools.partial(kwargs["guess_fn"], restart_draws=draws)
    return config, kwargs


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _recorded(fn, log):
    """``fn`` with each call's arguments and outputs appended to ``log`` as
    numpy arrays."""
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        log.append(([_numpy(a) for a in args], [_numpy(o) for o in outs]))
        return out

    return wrapped


def _diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def _pose_diff(a, b):
    """Poses ``(K, 6)`` compared as rotation matrices and translations (an
    axis-angle of pi may come out with either sign)."""
    from davo_tpu_torch.geometry import so3_rotation_matrix

    a, b = torch.tensor(np.asarray(a, np.float64)), torch.tensor(np.asarray(b, np.float64))
    return max(_diff(so3_rotation_matrix(a[:, :3]), so3_rotation_matrix(b[:, :3])), _diff(a[:, 3:], b[:, 3:]))


def _stages(j_log, t_log, port_chain):
    """Each stage's largest difference between the packages, in the order
    the pipeline runs them."""
    stages = [("render", _diff(j_log["frontend"][0][0][0], t_log["frontend"][0][0][0]))]
    stages.append(("detections", max(_diff(a, b) for a, b in zip(j_log["detections"][0][1], t_log["detections"][0][1]))))
    guesses = zip(*(iter(zip(j_log["guess"], t_log["guess"])),) * 3)
    for (j_win, t_win), rounds, (j_chain, t_chain) in zip(
            zip(j_log["frontend"][1:], t_log["frontend"][1:]), guesses, zip(j_log["chain"], t_log["chain"])):
        s = j_chain["kwargs"]["bootstrap_start"]
        stages.append((f"window {s} matches", _diff(j_win[1][0], t_win[1][0])))
        stages.append((f"window {s} visibility", _diff(j_win[1][1], t_win[1][1])))
        for r, (j_g, t_g) in enumerate(rounds):
            stages.append((f"window {s} guess call {r}", _diff(j_g[1][0], t_g[1][0])))
        names = ("intrinsics", "bootstrap poses", "bootstrap tracks", "bootstrap weights")
        for name, a, b in zip(names, j_chain["args"][2:], t_chain["args"][2:]):
            stages.append((f"chain {s} {name}", (_pose_diff if name == "bootstrap poses" else _diff)(a, b)))
        stages.append((f"chain {s} poses", _pose_diff(j_chain["out"][0], t_chain["out"][0])))
        stages.append((f"chain {s} cost", abs(float(j_chain["out"][1]) - float(t_chain["out"][1]))))
        est, cost = port_chain(j_chain)
        stages.append((f"port_chain_on_jax_inputs {s} poses", _pose_diff(j_chain["out"][0], est)))
        stages.append((f"port_chain_on_jax_inputs {s} cost", abs(float(j_chain["out"][1]) - cost)))
    return stages


@pytest.mark.slow
def test_official_recipe_same_draws(monkeypatch):
    from davo_tpu.data.rendering import RenderConfig
    from davo_tpu.train import vo_eval as J
    from davo_tpu_torch.train import vo_eval as T
    from tests.test_torch_vo_incremental import _jax_render_draws, _jax_trajectory_draws

    def recording_chain(solve, log):
        def wrapped(*args, **kwargs):
            out = solve(*args, **kwargs)
            log["chain"].append(dict(args=[_numpy(a) for a in args[:6]], kwargs=kwargs,
                                     out=(_numpy(out[0]), float(out[1]))))
            return out

        return wrapped

    port_solve = T.solve_incremental_vo_detections

    def port_chain(j_chain):
        """The port's accumulator from the JAX package's inputs to it."""
        kwargs = {k: v for k, v in j_chain["kwargs"].items() if k != "debug_out"}
        est, cost = port_solve(*(torch.tensor(a) for a in j_chain["args"]), **kwargs)
        return est.numpy(), float(cost)

    agree, rows = 0, []
    with jax.enable_x64(False):
        j_kwargs = _jax_pipeline(monkeypatch)
        config, kwargs = _port_pipeline()
        j_log, t_log = {}, {}
        for name in ("frontend", "detections", "guess"):
            j_kwargs[f"{name}_fn"] = _recorded(j_kwargs[f"{name}_fn"], j_log.setdefault(name, []))
            kwargs[f"{name}_fn"] = _recorded(kwargs[f"{name}_fn"], t_log.setdefault(name, []))
        j_log["chain"], t_log["chain"] = [], []
        monkeypatch.setattr(J, "solve_incremental_vo_detections", recording_chain(J.solve_incremental_vo_detections, j_log))
        monkeypatch.setattr(T, "solve_incremental_vo_detections", recording_chain(port_solve, t_log))
        j_cfg = J.TrajectoryConfig(num_frames=16, num_points=8, window=4)
        for trial in range(TRIALS):
            for log in (j_log, t_log):
                for calls in log.values():
                    calls.clear()
            key = jax.random.key(100 + trial)
            j_debug, t_debug = {}, {}
            j_ate = J.evaluate_learned_vo(key=key, config=j_cfg, pipeline="incremental", ba_irls=2,
                                          debug_out=j_debug, **j_kwargs)
            noise = dict(trajectory=_jax_trajectory_draws(key, j_cfg),
                         render=_jax_render_draws(jax.random.fold_in(key, 11), 16, 8, RenderConfig(image_size=96)))
            t_ate = T.evaluate_learned_vo(generator=None, config=config, noise=noise, debug_out=t_debug, **kwargs)
            stages = _stages(j_log, t_log, port_chain)
            row = dict(trial=trial, jax_rmse=float(j_ate["rmse"]), port_rmse=float(t_ate["rmse"]),
                       jax_bootstrap_costs=j_debug["bootstrap_costs"], port_bootstrap_costs=t_debug["bootstrap_costs"],
                       jax_chosen=j_debug["chosen_bootstrap"], port_chosen=t_debug["chosen_bootstrap"],
                       first_stage_apart=next((name for name, d in stages if d > AGREE), None),
                       stages=dict(stages))
            row["abs_diff"] = abs(row["jax_rmse"] - row["port_rmse"])
            agree += row["abs_diff"] <= AGREE
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"trials": TRIALS, "agree_to_1e-3": agree,
                      "jax_mean": float(np.mean([r["jax_rmse"] for r in rows])),
                      "port_mean": float(np.mean([r["port_rmse"] for r in rows]))}), flush=True)
    assert all(np.isfinite([r["jax_rmse"], r["port_rmse"]]).all() for r in rows)
