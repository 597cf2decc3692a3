"""Command-line entry of the port (the ``fit``, ``eval``, ``fit-frontend``,
``fit-learned-solver``, ``vo-eval``, ``eval-seq``, ``eval-distorted``,
``presets`` and ``runs`` subcommands of ``davo_tpu/cli.py``; ``bench`` is
not ported).

    python -m davo_tpu_torch.cli fit --preset calibration_from_oracle_matches \\
        --epochs 5 --checkpoint-dir <dir> --metrics-file <file.jsonl>
    python -m davo_tpu_torch.cli eval --preset calibration_transformer_curriculum \\
        --checkpoint-dir <dir holding an Orbax checkpoint_<step>/ or checkpoint_<step>.pkl> \\
        --hidden-size 448 --transformer-layers 10 --transformer-heads 8 --restarts 8 \\
        [--restart-proposals noise|permutation|input_noise|tokens] [--selection error|basin] \\
        [--basin-anchor W] [--guess-tokens E] [--solver lbfgs [--lbfgs-history M]]
    python -m davo_tpu_torch.cli fit --preset bfgs_solver_full_gradient | bfgs_solver_only_error_gradient \\
        | mlp_guess --epochs 5 --checkpoint-dir <dir>
    python -m davo_tpu_torch.cli fit-frontend --image-size 96 --epochs 600 \\
        --checkpoint-dir <dir> --metrics-file <file.jsonl>
    python -m davo_tpu_torch.cli fit-learned-solver --solver-type mlp|transformer|direction \\
        [--loss-mode final|descent] --epochs 20 [--checkpoint-file <file.pkl>]
    python -m davo_tpu_torch.cli vo-eval --checkpoint <weights.pkl> --hidden-size 384 \\
        --transformer-layers 8 --transformer-heads 8 [--stitch global|robust|chain] \\
        [--multistart H] [--host-polish] [--no-refine] --trials 3
    python -m davo_tpu_torch.cli vo-eval --checkpoint <weights.pkl> --hidden-size 384 \\
        --transformer-layers 8 --transformer-heads 8 --pipeline incremental \\
        --association geometric --no-refine --matches learned \\
        --frontend-checkpoint artifacts/ckpt_frontend_v4 [gates] --trials 4
    python -m davo_tpu_torch.cli eval-seq --gt <gt.txt> [--est <est.txt>] [--format tum|kitti] \\
        [--checkpoint <weights.pkl> --points 8 [--frontend-checkpoint <npz or dir>]]
    python -m davo_tpu_torch.cli eval-distorted [--batches 4 --batch-size 16 --points 32 \\
        --perturbation 0.02 --pixel-noise 0 --lm-iterations 60 --seed 0]
    python -m davo_tpu_torch.cli fit --config configurations/mlp_guess_config.yaml
    python -m davo_tpu_torch.cli presets
    python -m davo_tpu_torch.cli runs list|show <run id>|compare [<run id> ...] [--registry-dir artifacts/runs]

``fit`` trains the preset (``train/calibration.py::fit``: checkpoints of
the whole state every 25 epochs and at the end in ``--checkpoint-dir``,
Orbax directories as the JAX trainer writes, which a later ``fit`` of
either package resumes from), prints a JSON line per split and epoch
(also appended to ``--metrics-file``), the path of the final checkpoint
(``checkpoint: <dir>/checkpoint_<global epochs>``, which ``eval`` and the
JAX package's ``restore_checkpoint`` read) and ``{"final_val": ...}``
last.  Wherever a
command takes a checkpoint directory it reads the JAX package's pickles
and its Orbax ``checkpoint_<step>/`` directories alike
(``train/checkpoint.py::restore_checkpoint``).
On a gen-1 preset (``bfgs_solver_*``, ``mlp_guess``: the MLP guess with
the analytic-gradient BFGS unrolled in training, or alone) ``fit`` trains
it (``train/optimisation.py``), prints a ``train`` line an epoch, saves
``{"params", "batch_stats"}`` in the flax names as the Orbax directory
``checkpoint_<epochs>`` in ``--checkpoint-dir``, prints its path and
``{"final_train": ...}`` last; ``eval`` refuses such a preset with exit
code 2, as the JAX CLI does.
``eval`` builds the preset's network (flax-style random weights from
``--seed`` unless ``--checkpoint-dir`` names a checkpoint), solves
``--batches`` batches of ``--batch-size`` scenes for the eval metrics and
``--ate-batches`` more (four, as the JAX CLI) for the trajectory
accuracy, and prints one JSON line: the mean
eval metrics and ``ate_rmse_mean``, ``ate_rmse_median``, ``f_error_mean``
and ``centre_error_mean``.  ``--solver lbfgs`` swaps the preset's BFGS
for L-BFGS (the shared fields carried over, the memory from
``--lbfgs-history``), in ``fit`` and ``eval``.  ``fit-frontend`` trains
the visual front end (``train/frontend.py::fit_frontend``), prints a JSON
line per split and epoch, saves ``{"params", "batch_stats"}`` as the
Orbax directory ``checkpoint_<epochs>`` in ``--checkpoint-dir`` with its
``frontend_config.json`` (which ``models/convert.py::load_frontend`` and
the JAX package read), prints its path and ``{"final": ...}`` last.  ``fit-learned-solver`` trains a
learned solver on the calibration objective (``train/learned_solver.py``),
prints a ``train`` line an epoch, pickles ``{"params", "batch_stats",
"config"}`` to ``--checkpoint-file`` (numpy arrays and plain types, which
either package reads), then compares it with BFGS on 8 batches (seed
``--seed + 1``) and prints ``{"comparison": ...}`` last.  ``vo-eval`` runs the learned VO
(``train/vo_eval.py::evaluate_learned_vo``) on ``--trials`` synthetic
sequences: by default the windows pipeline (every window solved by the
curriculum preset's eval solver, all windows in one stacked call, then
``--stitch`` and the refinement: ``--multistart`` hypotheses, else one
global refinement unless ``--no-refine``, and with ``--host-polish`` the
float64 polish), or ``--pipeline incremental`` (a learned bootstrap and
the accumulator); with ``--matches learned`` the front end of
``--frontend-checkpoint`` (an ``.npz`` with its ``.json``, or a
``fit-frontend`` directory of either package, pickle or Orbax; see
``models/convert.py::load_frontend``)
supplies the observations.  It prints a JSON line a trial and
``{"mean_ate_rmse": ...}`` last, as the JAX CLI.  Trial ``t`` draws from
a generator seeded ``100 + t`` (the JAX CLI's key).  ``eval-seq`` compares
an ``--est`` trajectory file with ``--gt`` (ATE and RPE, TUM timestamps
associated within ``--max-dt``), or runs VO along ``--gt`` on landmarks
synthesised along it (oracle windows, or the learned pipeline with
``--checkpoint``, from rendered frames with ``--frontend-checkpoint``),
and prints one JSON line of the JAX CLI's keys.  ``eval-distorted``
recovers the 16 Brown-Conrady parameters by Levenberg-Marquardt on
``--batches`` batches (batch ``i`` drawn from a generator seeded ``--seed
+ i``) and prints the metrics' averages and ``worst_max_param_error``.
``fit`` and ``eval`` take ``--config`` (a YAML file of
``configurations/``: its ``preset:`` replaces ``--preset``, the flags
override both; it needs PyYAML), and the training commands
``--tensorboard-dir`` (it needs the ``tensorboard`` package).  ``fit``,
``fit-frontend`` and ``fit-learned-solver`` register their run in
``--registry-dir`` (``artifacts/runs``, the JAX package's registry, whose
rows either package reads) and stamp its manifest into the metrics file
and the checkpoint directory; ``fit`` prints its ``run_id``,
``config_hash`` and ``git_sha`` first.  ``presets`` lists the presets and
``runs list|show|compare`` browses the registry.  Every subcommand runs on
the card; ``--platform cpu`` selects the CPU.  Scenes are drawn by
``torch.Generator``s seeded from ``--seed``, not by ``jax.random``, so
the figures match the JAX package's statistically.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence

import torch

from davo_tpu_torch.train.runs import DEFAULT_REGISTRY_DIR

__all__ = ["main", "run", "vo_eval_setup"]

_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}
_TENSORBOARD_HELP = "TensorBoard event dir (needs the tensorboard package)"
_REGISTRY_HELP = "run registry directory (registry.jsonl; the JAX package's by default)"


def _add_common(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's common flags."""
    p.add_argument("--preset", default="calibration_from_oracle_matches")
    p.add_argument(
        "--config", default=None,
        help="YAML experiment config (see configurations/*.yaml); its optional `preset:` key replaces --preset, "
        "CLI flags override both (needs PyYAML)",
    )
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--batches-per-epoch", type=int, default=None)
    p.add_argument("--val-batches", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None,
                   help="fit: where the Orbax checkpoint_<step>/ directories go (and resume from); "
                        "eval: read the latest, an Orbax directory or a checkpoint_<step>.pkl")
    p.add_argument("--metrics-file", default=None, help="JSONL metrics log")
    p.add_argument("--tensorboard-dir", default=None, help=_TENSORBOARD_HELP)
    p.add_argument("--registry-dir", default=DEFAULT_REGISTRY_DIR, help=_REGISTRY_HELP)
    p.add_argument("--platform", default=None, help="cpu, or the card (the default)")
    p.add_argument("--head", default=None, help="guess head: mlp | transformer")
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--hidden-size", type=int, default=None)
    p.add_argument("--transformer-layers", type=int, default=None)
    p.add_argument("--transformer-heads", type=int, default=None)
    p.add_argument("--guess-tokens", type=int, default=None, help="transformer-head readout tokens")
    p.add_argument("--solver", choices=("bfgs", "lbfgs"), default=None, help="in-forward solver")
    p.add_argument("--lbfgs-history", type=int, default=None, help="L-BFGS memory m")


def _apply_overrides(config, args):
    updates = {}
    for field in ("epochs", "batch_size", "batches_per_epoch", "val_batches", "seed", "head", "learning_rate",
                  "hidden_size", "transformer_layers", "transformer_heads", "guess_tokens"):
        value = getattr(args, field, None)
        if value is not None and hasattr(config, field):
            updates[field] = value
    if updates:
        config = dataclasses.replace(config, **updates)
    if getattr(args, "solver", None) == "lbfgs" and hasattr(config, "solver"):
        from davo_tpu_torch.solve import LBFGSConfig

        # the fields the two configs share carry over; the memory from the flag
        shared = {f.name for f in dataclasses.fields(LBFGSConfig)} & {
            f.name for f in dataclasses.fields(type(config.solver))
        }
        kwargs = {k: getattr(config.solver, k) for k in shared}
        if getattr(args, "lbfgs_history", None):
            kwargs["history"] = args.lbfgs_history
        config = dataclasses.replace(config, solver=LBFGSConfig(**kwargs))
    return config


def _frontend_config(args):
    """The front-end experiment with ``fit-frontend``'s overrides (the JAX
    CLI's: ``--select`` defaults to ``--points``, ``--image-size`` sets the
    rendered size)."""
    from davo_tpu_torch.train import FrontendExperiment

    config = FrontendExperiment()
    updates = {}
    for cli_name, field in (
        ("epochs", "epochs"), ("batch_size", "batch_size"), ("batches_per_epoch", "batches_per_epoch"),
        ("image_size", "image_size"), ("points", "num_points"), ("views", "num_views"),
        ("learning_rate", "learning_rate"), ("seed", "seed"),
    ):
        value = getattr(args, cli_name, None)
        if value is not None:
            updates[field] = value
    if args.select:
        updates["num_select"] = args.select
    if "num_points" in updates:
        updates.setdefault("num_select", updates["num_points"])
    if updates.get("image_size"):
        updates["render"] = dataclasses.replace(config.render, image_size=updates.pop("image_size"))
    return dataclasses.replace(config, **updates) if updates else config


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="davo_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    fit_p = sub.add_parser("fit", help="train a preset experiment")
    _add_common(fit_p)
    eval_p = sub.add_parser("eval", help="evaluate a trained checkpoint")
    _add_common(eval_p)
    eval_p.add_argument("--batches", type=int, default=16)
    eval_p.add_argument("--ate-batches", type=int, default=4, help="batches for the trajectory accuracy")
    eval_p.add_argument("--restarts", type=int, default=None, help="multi-start eval solves")
    eval_p.add_argument("--selection", default=None, help="restart selection: error | basin")
    eval_p.add_argument(
        "--restart-proposals", default=None, help="restart proposals: noise | permutation | input_noise | tokens"
    )
    eval_p.add_argument(
        "--basin-anchor", type=float, default=None, help="basin-score pull towards the guess focal (0 disables)"
    )
    fe_p = sub.add_parser("fit-frontend", help="train the visual front end (detector + attention matcher)")
    for flag, kind in (("--epochs", int), ("--batch-size", int), ("--batches-per-epoch", int), ("--image-size", int),
                       ("--points", int), ("--views", int), ("--learning-rate", float), ("--seed", int)):
        fe_p.add_argument(flag, type=kind, default=None)
    fe_p.add_argument("--select", type=int, default=None, help="solver-facing tracks per window (default: --points)")
    fe_p.add_argument("--checkpoint-dir", default=None,
                      help="where the Orbax checkpoint_<epochs>/ and frontend_config.json go")
    fe_p.add_argument("--metrics-file", default=None, help="JSONL metrics log")
    fe_p.add_argument("--tensorboard-dir", default=None, help=_TENSORBOARD_HELP)
    fe_p.add_argument("--registry-dir", default=DEFAULT_REGISTRY_DIR, help=_REGISTRY_HELP)
    fe_p.add_argument("--platform", default=None, help="cpu, or the card (the default)")
    _add_fit_learned_solver(sub)
    _add_vo_eval(sub)
    _add_eval_seq(sub)
    _add_eval_distorted(sub)
    sub.add_parser("presets", help="list experiment presets")
    runs_p = sub.add_parser(
        "runs",
        help="browse the run registry: list runs, show one run's manifest and final metrics, or compare several "
        "side by side",
    )
    runs_p.add_argument("action", choices=("list", "show", "compare"))
    runs_p.add_argument("run_ids", nargs="*",
                        help="run ids for show/compare (unique prefixes accepted; compare with none selects every run)")
    runs_p.add_argument("--registry-dir", default=DEFAULT_REGISTRY_DIR)
    runs_p.add_argument("--split", default="val", help="metrics split for compare")
    return parser


def _add_eval_distorted(sub) -> None:
    """``eval-distorted``'s flags and defaults, as the JAX CLI's."""
    p = sub.add_parser(
        "eval-distorted",
        help="Brown-Conrady distorted calibration: LM recovery of all 16 parameters from observed pixels of known "
        "world points (scenes drawn by torch generators: other draws than jax.random's, the same statistics)",
    )
    for flag, kind, default in (
        ("--batches", int, 4), ("--batch-size", int, 16), ("--points", int, 32), ("--perturbation", float, 0.02),
        ("--pixel-noise", float, 0.0), ("--lm-iterations", int, 60), ("--seed", int, 0),
    ):
        p.add_argument(flag, type=kind, default=default)
    p.add_argument("--platform", default=None, help="cpu, or the card (the default)")


def _eval_distorted(args, device) -> dict:
    """``eval-distorted``: the metrics of each batch (batch ``i`` from a
    generator seeded ``--seed + i``), averaged, and the worst batch's
    ``max_param_error``."""
    from davo_tpu_torch.camera import DistortedSceneConfig, evaluate_distorted_calibration
    from davo_tpu_torch.solve.least_squares import LMConfig

    results = [
        evaluate_distorted_calibration(
            torch.Generator(device).manual_seed(args.seed + i), batch=args.batch_size,
            perturbation=args.perturbation, pixel_noise=args.pixel_noise,
            scene=DistortedSceneConfig(num_points=args.points), lm=LMConfig(iterations=args.lm_iterations),
            device=device,
        )
        for i in range(args.batches)
    ]
    avg = {k: float(sum(r[k] for r in results) / len(results)) for k in results[0]}
    avg["worst_max_param_error"] = float(max(r["max_param_error"] for r in results))
    return avg


def _presets() -> None:
    """``presets``: one ``name: ConfigClass`` line a preset, as the JAX CLI."""
    from davo_tpu_torch.train import PRESETS

    for name, make_config in sorted(PRESETS.items()):
        print(f"{name}: {type(make_config()).__name__}")


def _runs(args) -> None:
    """``runs list|show|compare``: the registry's rows, one run's manifest
    with its final metrics, or several runs' final metrics and config
    differences (the JAX CLI's lines and exit codes)."""
    from davo_tpu_torch.train.runs import compare_runs, final_metrics, load_registry, metrics_path_for

    rows = load_registry(args.registry_dir)
    if not rows:
        raise _Refused(f"no runs registered under {args.registry_dir}", code=1)

    def select(prefix):
        matches = [r for r in rows if r.get("run_id", "").startswith(prefix)]
        if not matches:
            raise _Refused(f"no run matches {prefix!r}", code=1)
        if len(matches) > 1:
            raise _Refused(f"{prefix!r} is ambiguous: " + ", ".join(r["run_id"] for r in matches), code=1)
        return matches

    if args.action == "list":
        for row in rows:
            final = final_metrics(row)
            loss = (final.get("val") or final.get("train") or {}).get("loss")
            print(json.dumps({
                "run_id": row.get("run_id"),
                "name": row.get("name"),
                "created": row.get("created"),
                "git_sha": (row.get("git_sha") or "")[:10],
                "backend": row.get("backend"),
                "checkpoint_dir": row.get("checkpoint_dir"),
                "final_loss": None if loss is None else round(loss, 6),
            }), flush=True)
    elif args.action == "show":
        if len(args.run_ids) != 1:
            raise _Refused("runs show takes exactly one run id", code=2)
        row = select(args.run_ids[0])[0]
        print(json.dumps({**row, "metrics_file": metrics_path_for(row), "final_metrics": final_metrics(row)},
                         indent=2), flush=True)
    else:
        selected = [m for prefix in args.run_ids or [r["run_id"] for r in rows] for m in select(prefix)]
        print(json.dumps(compare_runs(selected, split=args.split), indent=2), flush=True)


def _register(config, args, name, checkpoint_dir=None) -> dict:
    """Register a training run (the JAX CLI's manifest, tagged with the
    command) and return its manifest."""
    from davo_tpu_torch.train.runs import make_run_manifest, register_run

    manifest = make_run_manifest(config, name=name, tags={"command": args.command}, argv=sys.argv[:1] + args.argv)
    register_run(manifest, registry_dir=args.registry_dir, checkpoint_dir=checkpoint_dir)
    return manifest


def _add_fit_learned_solver(sub) -> None:
    """``fit-learned-solver``'s flags, as the JAX CLI's."""
    p = sub.add_parser(
        "fit-learned-solver",
        help="train an MLP/transformer learned solver on the calibration objective and compare against BFGS at "
        "equal step budget",
    )
    p.add_argument("--solver-type", default="mlp", choices=("mlp", "transformer", "direction"),
                   help="mlp/transformer: learned update rule; direction: train the SearchDirectionHeuristic gate "
                   "inside the real BFGS solve")
    p.add_argument("--loss-mode", default=None, choices=("final", "descent"),
                   help="final-objective loss, or per-step descent-aligned loss")
    p.add_argument("--steps", type=int, default=None, help="solver steps")
    for flag, kind in (("--epochs", int), ("--batch-size", int), ("--batches-per-epoch", int),
                       ("--hidden-size", int), ("--learning-rate", float), ("--start-noise", float),
                       ("--seed", int)):
        p.add_argument(flag, type=kind, default=None)
    p.add_argument("--no-recurrent", action="store_true")
    p.add_argument("--metrics-file", default=None, help="JSONL metrics log")
    p.add_argument("--checkpoint-file", default=None, help="pickle the trained solver state here")
    p.add_argument("--tensorboard-dir", default=None, help=_TENSORBOARD_HELP)
    p.add_argument("--registry-dir", default=DEFAULT_REGISTRY_DIR, help=_REGISTRY_HELP)
    p.add_argument("--platform", default=None, help="cpu, or the card (the default)")


def _fit_learned_solver(args, device) -> dict:
    """``fit-learned-solver``: register the run, train, optionally pickle,
    compare with BFGS."""
    import pickle

    from davo_tpu_torch.train import LearnedSolverExperiment, MetricsLogger, compare_with_bfgs, fit_learned_solver
    from davo_tpu_torch.train.learned_solver import learned_solver_checkpoint

    config = LearnedSolverExperiment(solver_type=args.solver_type)
    updates = {}
    for cli_name, field in (
        ("steps", "num_steps"), ("epochs", "epochs"), ("batch_size", "batch_size"),
        ("batches_per_epoch", "batches_per_epoch"), ("hidden_size", "hidden_size"),
        ("learning_rate", "learning_rate"), ("start_noise", "start_noise"), ("seed", "seed"),
    ):
        value = getattr(args, cli_name)
        if value is not None:
            updates[field] = value
    if args.no_recurrent:
        updates["recurrent"] = False
    if args.loss_mode:
        updates["loss_mode"] = args.loss_mode
    config = dataclasses.replace(config, **updates)
    manifest = _register(config, args, "fit-learned-solver")
    logger = MetricsLogger(args.metrics_file, tensorboard_dir=args.tensorboard_dir, run=manifest)
    try:
        state, _ = fit_learned_solver(config, log_fn=logger, device=device)
    finally:
        logger.close()
    if args.checkpoint_file:
        with open(args.checkpoint_file, "wb") as f:
            pickle.dump(learned_solver_checkpoint(state.network, config), f)
    return {"comparison": compare_with_bfgs(state.network, config, config.seed + 1, device=device)}


class _Refused(NotImplementedError):
    """A request the JAX CLI refuses too (a preset without eval, a run the
    registry does not hold): :func:`main` prints the message and returns
    the JAX CLI's exit code."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


def _fit_gen1(args, config, device, logger) -> dict:
    """A gen-1 preset: ``fit`` only (the JAX CLI's route)."""
    from davo_tpu_torch.models.convert import flax_tree_from_state_dict
    from davo_tpu_torch.train import fit_optimisation, save_checkpoint

    if args.command != "fit":
        raise _Refused(f"preset {args.preset!r} supports 'fit' only")
    state, history = fit_optimisation(config, log_fn=logger, device=device)
    if args.checkpoint_dir:
        params, batch_stats = flax_tree_from_state_dict(state.network.state_dict())
        path = save_checkpoint(args.checkpoint_dir, len(history["train"]),
                               {"params": params, "batch_stats": batch_stats})
        print(f"checkpoint: {path}", flush=True)
    return {"final_train": history["train"][-1]}


def _add_vo_eval(sub) -> None:
    """``vo-eval``'s flags, as the JAX CLI's (``--platform`` added)."""
    p = sub.add_parser("vo-eval", help="full learned VO on synthetic sequences")
    p.add_argument("--checkpoint", required=True, help="checkpoint .pkl")
    for flag, kind, default in (
        ("--frames", int, 16), ("--window", int, 4), ("--points", int, 8), ("--trials", int, 3),
        ("--restarts", int, 8), ("--basin-anchor", float, 0.0), ("--hidden-size", int, None),
        ("--transformer-layers", int, None), ("--transformer-heads", int, None), ("--stride", int, 0),
        ("--refine-rounds", int, 1), ("--multistart", int, 0), ("--pnp-ransac", int, 0),
        ("--chain-passes", int, 1), ("--ba-irls", int, 0), ("--ba-iterations", int, None),
        ("--num-bootstraps", int, 3), ("--window-irls", int, 0), ("--soft-gate-floor", float, 0.0),
        ("--image-size", int, 64), ("--match-confidence", float, 0.0), ("--nms-radius", float, 0.1),
        ("--snap-radius", float, 0.0), ("--cycle-threshold", float, 0.0), ("--quality-bonus", float, 0.0),
        ("--score-threshold", float, 0.0), ("--centroid-refine", int, 0), ("--scene-points", int, 0),
        ("--track-points", int, 0),
    ):
        p.add_argument(flag, type=kind, default=default)
    p.add_argument("--selection", default="error", help="error | basin")
    p.add_argument("--no-refine", action="store_true")
    p.add_argument(
        "--stitch", default="global",
        help="window stitching: global (overlap-consistent joint centre/scale solve) | robust (global with "
        "Huber-IRLS edge weights) | chain (greedy single-pair scale chaining)",
    )
    p.add_argument("--host-polish", action="store_true",
                   help="a final float64 global BA (on the estimates' device: the card has float64)")
    p.add_argument("--platform", default=None, help="cpu, or the card (the default)")
    p.add_argument("--pipeline", default="windows", choices=("windows", "incremental"))
    p.add_argument("--association", default="geometric", choices=("geometric", "descriptor"))
    p.add_argument("--matches", default="oracle", choices=("oracle", "learned"))
    p.add_argument("--frontend-checkpoint", default=None,
                   help="front-end .npz, or a fit-frontend directory (pickle or the JAX CLI's Orbax checkpoints)")
    p.add_argument("--track-anchors", type=int, default=1, choices=(1, 2))


def _add_eval_seq(sub) -> None:
    """``eval-seq``'s flags, as the JAX CLI's."""
    p = sub.add_parser(
        "eval-seq",
        help="evaluate trajectories in TUM/KITTI file formats: compare an estimate against ground truth, or run "
        "windowed VO along a ground-truth file with synthesised landmarks",
    )
    p.add_argument("--gt", required=True, help="ground-truth trajectory file")
    p.add_argument("--est", default=None, help="estimated trajectory file (compare mode)")
    p.add_argument("--format", default="tum", choices=("tum", "kitti"))
    p.add_argument("--max-dt", type=float, default=0.02, help="TUM association window (s)")
    p.add_argument("--intrinsics", default=None, help="intrinsics file (fx fy cx cy)")
    p.add_argument("--calib", default=None, help="KITTI calib.txt (P0 row)")
    for flag, kind, default in (
        ("--window", int, 4), ("--points", int, 32), ("--max-frames", int, None), ("--rpe-delta", int, 1),
        ("--seed", int, 0), ("--restarts", int, 8), ("--hidden-size", int, None),
        ("--transformer-layers", int, None), ("--transformer-heads", int, None),
    ):
        p.add_argument(flag, type=kind, default=default)
    p.add_argument("--platform", default=None, help="cpu, or the card (the default)")
    p.add_argument("--checkpoint", default=None,
                   help="guess-network .pkl: run the learned windowed VO along the file instead of the oracle solver")
    p.add_argument("--frontend-checkpoint", default=None,
                   help="front-end .npz, or a fit-frontend directory (pickle or the JAX CLI's Orbax checkpoints): "
                   "render frames along the file and take every "
                   "window's observations from the front end (requires --checkpoint)")
    p.add_argument("--stitch", default="global", help="global | robust | chain")
    p.add_argument("--pipeline", default="windows", choices=("windows", "incremental"),
                   help="windows: per-window solves + stitching; incremental: learned bootstrap + "
                   "PnP/triangulation/BA over detections")


def _eval_seq(args, device) -> dict:
    """``eval-seq``: compare mode (``--est``: TUM timestamps associated
    within ``--max-dt``, else the common prefix; ATE and RPE in float64),
    or VO along ``--gt`` (oracle windows, or the learned pipeline with
    ``--checkpoint`` and ``--frontend-checkpoint``, the JAX CLI's gates:
    NMS 0.1, centroid refinement 2, snap 0.08, cycle 0.08, quality bonus
    10, score 0.5)."""
    from davo_tpu_torch.data.sequences import (
        associate_timestamps,
        load_kitti_calib,
        load_sequence,
        load_tum_intrinsics,
    )
    from davo_tpu_torch.train.evaluation import (
        absolute_trajectory_error,
        camera_centers_from_poses,
        relative_pose_error,
    )
    from davo_tpu_torch.train.vo_eval import TrajectoryConfig, evaluate_vo_sequence_file

    intrinsics = None
    if args.intrinsics:
        intrinsics = load_tum_intrinsics(args.intrinsics, device=device)
    elif args.calib:
        intrinsics = load_kitti_calib(args.calib, device=device)
    if args.est:
        gt = load_sequence(args.gt, args.format, device=device, dtype=torch.float64)
        est = load_sequence(args.est, args.format, device=device, dtype=torch.float64)
        gt_poses, est_poses = gt.poses, est.poses
        if args.format == "tum" and gt.timestamps is not None and est.timestamps is not None:
            ia, ib = associate_timestamps(est.timestamps, gt.timestamps, max_dt=args.max_dt)
            if len(ia) == 0:
                raise ValueError("no associated timestamp pairs")
            est_poses, gt_poses = est.poses[torch.as_tensor(ia, device=device)], gt.poses[torch.as_tensor(ib,
                                                                                                            device=device)]
        else:
            k = min(gt_poses.shape[0], est_poses.shape[0])
            gt_poses, est_poses = gt_poses[:k], est_poses[:k]
        est_c = camera_centers_from_poses(est_poses[:, 0:3], est_poses[:, 3:6])
        gt_c = camera_centers_from_poses(gt_poses[:, 0:3], gt_poses[:, 3:6])
        metrics = {f"ate_{name}": value for name, value in absolute_trajectory_error(est_c, gt_c).items()}
        metrics.update({f"rpe_{name}": value
                        for name, value in relative_pose_error(est_poses, gt_poses, delta=args.rpe_delta).items()})
        metrics["pairs"] = est_poses.shape[0]
        return {k: float(v) for k, v in metrics.items()}

    guess_fn = frontend_fn = detections_fn = render_config = None
    if args.checkpoint:
        guess_fn = _guess_fn(_guess_network(args, device))
        if args.frontend_checkpoint:
            from davo_tpu_torch.models import load_frontend

            frontend, render_config = load_frontend(
                args.frontend_checkpoint, device=device, default_points=args.points, nms_radius=0.1,
                centroid_refine_iters=2, snap_radius=0.08, cycle_threshold=0.08, quality_bonus=10.0,
                score_threshold=0.5,
            )

            def frontend_fn(images):
                out = frontend(images)
                return out.matches, out.match_visibility

            if args.pipeline == "incremental":
                def detections_fn(images):
                    out = frontend(images)
                    return out.points, torch.sigmoid(out.scores)
    elif args.frontend_checkpoint:
        raise ValueError("--frontend-checkpoint requires --checkpoint")
    metrics = evaluate_vo_sequence_file(
        args.gt, format=args.format, config=TrajectoryConfig(window=args.window),
        generator=torch.Generator(device).manual_seed(args.seed), intrinsics=intrinsics, max_frames=args.max_frames,
        num_points=args.points, guess_fn=guess_fn, frontend_fn=frontend_fn, render_config=render_config,
        stitch=args.stitch, pipeline=args.pipeline, detections_fn=detections_fn, device=device,
    )
    return {k: float(v) for k, v in metrics.items()}


def _fit_frontend(args, device) -> dict:
    from davo_tpu_torch.train import MetricsLogger, fit_frontend, save_frontend_checkpoint

    config = _frontend_config(args)
    manifest = _register(config, args, "fit-frontend", checkpoint_dir=args.checkpoint_dir)
    logger = MetricsLogger(args.metrics_file, tensorboard_dir=args.tensorboard_dir, run=manifest)
    try:
        state, history = fit_frontend(config, log_fn=logger, device=device)
    finally:
        logger.close()
    if args.checkpoint_dir:
        path = save_frontend_checkpoint(args.checkpoint_dir, len(history["train"]), state.network, config)
        print(f"checkpoint: {path}", flush=True)
    return {"final": history["val"][-1] if history["val"] else history["train"][-1]}


def _guess_network(args, device, **fields):
    """The guess network at ``args.checkpoint`` (the JAX package's numpy
    pickle) with the curriculum preset's eval solver (the JAX CLI's single
    source of truth for the eval solve budget), ``args.window`` views,
    ``args.points`` points, ``args.restarts`` restarts and the width
    flags."""
    from davo_tpu_torch.models import load_flax_weights, load_numpy_checkpoint
    from davo_tpu_torch.train import get_preset

    net_cfg = dataclasses.replace(
        get_preset("calibration_transformer_curriculum"), num_views=args.window, num_points=args.points,
        num_restarts=args.restarts, **fields,
    )
    for field in ("hidden_size", "transformer_layers", "transformer_heads"):
        if getattr(args, field) is not None:
            net_cfg = dataclasses.replace(net_cfg, **{field: getattr(args, field)})
    net = net_cfg.build_network(device)
    restored = load_numpy_checkpoint(args.checkpoint)
    load_flax_weights(net, restored["params"], restored.get("batch_stats"))
    return net


def _guess_fn(net):
    """The VO pipelines' guess function: rows in, rows out (``(B, M, N, 2),
    (B, M, N) -> (B, P)``).  Every row gets the restart draw of a one-row
    call (a generator seeded 0; ``restart_draws`` of shape ``(1, R - 1, P)``
    replaces it), as the JAX CLI's jitted guess draws ``key(0)`` a call:
    a window solved in a stack is solved as it would be alone."""
    def guess_fn(pixels, visibility, restart_draws=None, **network_kwargs):
        if restart_draws is None and net.num_restarts > 1 and net.restart_proposals == "noise":
            restart_draws = torch.randn((1, net.num_restarts - 1, net.num_parameters), dtype=pixels.dtype,
                                        device=pixels.device,
                                        generator=torch.Generator(pixels.device).manual_seed(0))
        if restart_draws is not None:
            restart_draws = restart_draws.expand(pixels.shape[0], -1, -1)
        return net(pixels, visibility, restart_draws=restart_draws, **network_kwargs)

    return guess_fn


def vo_eval_setup(args, device):
    """``vo-eval``'s sequence configuration and the keyword arguments of
    :func:`davo_tpu_torch.train.vo_eval.evaluate_learned_vo` (all but the
    generator) for parsed ``args``: the guess network at ``--checkpoint``
    with the curriculum preset's eval solver, the front end, and the
    incremental pipeline's options."""
    from davo_tpu_torch.models import load_flax_weights, load_frontend, load_numpy_checkpoint
    from davo_tpu_torch.train import get_preset
    from davo_tpu_torch.train.vo_eval import TrajectoryConfig

    if args.matches == "learned" and not args.frontend_checkpoint:
        raise ValueError("--matches learned requires --frontend-checkpoint")
    scene_points = args.scene_points or args.points
    if scene_points != args.points and args.matches != "learned":
        raise ValueError("--scene-points requires --matches learned (oracle matches go straight to the solver)")
    guess_fn = _guess_fn(_guess_network(args, device, selection=args.selection,
                                        basin_anchor_weight=args.basin_anchor))

    frontend_fn = track_fn = detections_fn = render_config = None
    if args.matches == "learned":
        frontend, render_config = load_frontend(
            args.frontend_checkpoint, device=device, default_points=args.points, image_size=args.image_size,
            match_confidence_threshold=args.match_confidence, nms_radius=args.nms_radius,
            snap_radius=args.snap_radius, cycle_threshold=args.cycle_threshold, quality_bonus=args.quality_bonus,
            score_threshold=args.score_threshold, centroid_refine_iters=args.centroid_refine,
            soft_gate_floor=args.soft_gate_floor,
        )
        # the whole-sequence forward serves both the tracks and the
        # detections: computed once per images tensor (held while cached)
        cache = {}

        def forward(images):
            key = (images.data_ptr(), tuple(images.shape), images.stride())
            if cache.get("key") != key:
                cache.update(key=key, images=images, out=frontend(images))
            return cache["out"]

        def frontend_fn(images):
            out = forward(images)
            return out.matches, out.match_visibility

        if args.pipeline == "incremental" and args.association == "geometric":
            def detections_fn(images):
                out = forward(images)
                return out.points, torch.sigmoid(out.scores)

        if (args.track_points and args.track_points != args.points) or args.track_anchors == 2:
            track_net = copy.copy(frontend)  # shares the weights
            track_net.num_select = args.track_points or args.points

            def track_fn(images):
                out = track_net(images)
                if args.track_anchors == 2:
                    rev = track_net(images.flip(1))
                    return (torch.cat([out.matches, rev.matches.flip(1)], dim=2),
                            torch.cat([out.match_visibility, rev.match_visibility.flip(1)], dim=2))
                return out.matches, out.match_visibility

    config = TrajectoryConfig(num_frames=args.frames, num_points=scene_points, window=args.window, stride=args.stride)
    if args.ba_iterations is not None:
        config = dataclasses.replace(config, solver=dataclasses.replace(config.solver, iterations=args.ba_iterations))
    return config, dict(
        guess_fn=guess_fn,
        refine=not args.no_refine,
        refine_rounds=args.refine_rounds,
        host_polish=args.host_polish,
        multistart=args.multistart,
        stitch=args.stitch,
        frontend_fn=frontend_fn,
        render_config=render_config,
        track_fn=track_fn,
        irls_rounds=args.window_irls,
        pipeline=args.pipeline,
        detections_fn=detections_fn,
        pnp_ransac=args.pnp_ransac,
        chain_passes=args.chain_passes,
        ba_irls=args.ba_irls,
        num_bootstraps=args.num_bootstraps,
        device=device,
    )


def _vo_eval(args, device) -> dict:
    """``vo-eval``: a JSON line of ATE figures a trial, then the mean
    (returned)."""
    from davo_tpu_torch.train.vo_eval import evaluate_learned_vo

    config, kwargs = vo_eval_setup(args, device)
    results = []
    for trial in range(args.trials):
        ate = evaluate_learned_vo(generator=torch.Generator(device).manual_seed(100 + trial), config=config, **kwargs)
        results.append({k: float(v) for k, v in ate.items()})
        print(json.dumps({"trial": trial, **results[-1]}), flush=True)
    mean_rmse = sum(r["rmse"] for r in results) / len(results)
    return {"mean_ate_rmse": float(f"{mean_rmse:.6g}")}


def run(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    """Parse ``argv`` and run the subcommand; returns what :func:`main`
    prints last (``presets`` and ``runs`` print their own lines and return
    None)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _build_parser().parse_args(argv)
    args.argv = argv  # recorded in a training run's manifest
    if args.command == "presets":
        return _presets()
    if args.command == "runs":
        return _runs(args)
    from davo_tpu_torch.train import MetricsLogger, get_preset, load_config_yaml
    from davo_tpu_torch.utils.device import resolve_device

    if args.platform is not None and args.platform not in _PLATFORMS:
        raise ValueError(f"--platform must be one of {sorted(_PLATFORMS)}, got {args.platform!r}")
    device = resolve_device(None if args.platform is None else _PLATFORMS[args.platform])
    if args.command == "vo-eval":
        return _vo_eval(args, device)
    if args.command == "eval-seq":
        return _eval_seq(args, device)
    if args.command == "eval-distorted":
        return _eval_distorted(args, device)
    if args.command == "fit-frontend":
        return _fit_frontend(args, device)
    if args.command == "fit-learned-solver":
        return _fit_learned_solver(args, device)
    config = _apply_overrides(load_config_yaml(args.config) if args.config else get_preset(args.preset), args)
    manifest = None
    if args.command == "fit":
        manifest = _register(config, args, args.config or args.preset, checkpoint_dir=args.checkpoint_dir)
        print(json.dumps({k: manifest[k] for k in ("run_id", "config_hash", "git_sha")}), flush=True)
    logger = MetricsLogger(args.metrics_file, tensorboard_dir=args.tensorboard_dir, run=manifest)
    try:
        return _fit_or_eval(args, config, device, logger)
    finally:
        logger.close()


def _fit_or_eval(args, config, device, logger) -> dict:
    """``fit`` or ``eval`` of a preset or ``--config`` experiment."""
    from davo_tpu_torch.models import load_flax_weights
    from davo_tpu_torch.train import (
        CalibrationExperiment,
        batch_generator,
        evaluate_calibration_ate,
        fit,
        latest_step,
        make_eval_step,
        restore_checkpoint,
    )

    if not isinstance(config, CalibrationExperiment):
        return _fit_gen1(args, config, device, logger)
    if args.command == "fit":
        _, history = fit(config, log_fn=logger, checkpoint_dir=args.checkpoint_dir, device=device)
        if args.checkpoint_dir:
            step = latest_step(args.checkpoint_dir)
            print(f"checkpoint: {os.path.join(os.path.abspath(args.checkpoint_dir), f'checkpoint_{step}')}", flush=True)
        return {"final_val": history["val"][-1] if history["val"] else {}}

    if args.restarts:
        config = dataclasses.replace(config, num_restarts=args.restarts)
    if args.selection:
        config = dataclasses.replace(config, selection=args.selection)
    if args.restart_proposals:
        config = dataclasses.replace(config, restart_proposals=args.restart_proposals)
    if args.basin_anchor is not None:
        config = dataclasses.replace(config, basin_anchor_weight=args.basin_anchor)
    network = config.build_network(device, generator=batch_generator("cpu", config.seed))
    if args.checkpoint_dir:
        restored = restore_checkpoint(args.checkpoint_dir)
        load_flax_weights(network, restored["params"], restored.get("batch_stats"))
    eval_step = make_eval_step(network, config)
    metrics = [eval_step(batch_generator(device, config.seed, 1000 + i)) for i in range(args.batches)]
    result = {k: float(torch.mean(torch.stack([m[k] for m in metrics]))) for k in metrics[0]}
    result.update(evaluate_calibration_ate(network, config, config.seed, batches=args.ate_batches))
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    try:
        result = run(argv)
    except _Refused as refused:
        print(refused, file=sys.stderr)
        return refused.code
    if result is not None:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
