"""Command-line entry of the port (the ``fit``, ``eval`` and
``fit-frontend`` subcommands of ``davo_tpu/cli.py``).

    python -m davo_tpu_torch.cli fit --preset calibration_from_oracle_matches \\
        --epochs 5 --checkpoint-dir <dir> --metrics-file <file.jsonl>
    python -m davo_tpu_torch.cli eval --preset calibration_transformer_curriculum \\
        --checkpoint-dir <dir holding checkpoint_<step>.pkl> \\
        --hidden-size 448 --transformer-layers 10 --transformer-heads 8 --restarts 8 \\
        [--restart-proposals noise|permutation|input_noise|tokens] [--selection error|basin] \\
        [--basin-anchor W] [--guess-tokens E] [--solver lbfgs [--lbfgs-history M]]
    python -m davo_tpu_torch.cli fit-frontend --image-size 96 --epochs 600 \\
        --checkpoint-dir <dir> --metrics-file <file.jsonl>

``fit`` trains the preset (``train/calibration.py::fit``: checkpoints of
the whole state every 25 epochs and at the end in ``--checkpoint-dir``,
which a later ``fit`` resumes from), prints a JSON line per split and
epoch (also appended to ``--metrics-file``), the path of the final
checkpoint (``checkpoint_<global epochs>.pkl``, which ``eval`` and the JAX
package's ``restore_checkpoint`` read) and ``{"final_val": ...}`` last.
``eval`` builds the preset's network (flax-style random weights from
``--seed`` unless ``--checkpoint-dir`` names a checkpoint), solves
``--batches`` batches of ``--batch-size`` scenes for the eval metrics and
four more for the trajectory accuracy, and prints one JSON line: the mean
eval metrics and ``ate_rmse_mean``, ``ate_rmse_median``, ``f_error_mean``
and ``centre_error_mean``.  ``--solver lbfgs`` swaps the preset's BFGS
for L-BFGS (the shared fields carried over, the memory from
``--lbfgs-history``), in ``fit`` and ``eval``.  ``fit-frontend`` trains
the visual front end (``train/frontend.py::fit_frontend``), prints a JSON
line per split and epoch, saves ``{"params", "batch_stats"}`` at step
``epochs`` in ``--checkpoint-dir`` with its ``frontend_config.json``
(which ``models/convert.py::load_frontend`` and the JAX package read),
and prints ``{"final": ...}`` last.  Every subcommand runs on the card;
``--platform cpu`` selects the CPU.  Scenes are drawn by
``torch.Generator``s seeded from ``--seed``, not by ``jax.random``, so
the figures match the JAX package's statistically.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Sequence

import torch

__all__ = ["main", "run"]

_PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}


def _add_common(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's common flags."""
    p.add_argument("--preset", default="calibration_from_oracle_matches")
    p.add_argument("--config", default=None, help="YAML experiment config (not ported yet)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--batches-per-epoch", type=int, default=None)
    p.add_argument("--val-batches", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--metrics-file", default=None, help="JSONL metrics log")
    p.add_argument("--tensorboard-dir", default=None, help="TensorBoard event dir (not ported yet)")
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
    if args.config:
        raise NotImplementedError("--config: YAML experiment configs are not ported yet (ROADMAP.md Queue 1 item 8)")
    updates = {}
    for field in ("epochs", "batch_size", "batches_per_epoch", "val_batches", "seed", "head", "learning_rate",
                  "hidden_size", "transformer_layers", "transformer_heads", "guess_tokens"):
        value = getattr(args, field, None)
        if value is not None:
            updates[field] = value
    if updates:
        config = dataclasses.replace(config, **updates)
    if getattr(args, "solver", None) == "lbfgs":
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
    fe_p.add_argument("--checkpoint-dir", default=None)
    fe_p.add_argument("--metrics-file", default=None, help="JSONL metrics log")
    fe_p.add_argument("--tensorboard-dir", default=None, help="TensorBoard event dir (not ported yet)")
    fe_p.add_argument("--platform", default=None, help="cpu, or the card (the default)")
    return parser


def _fit_frontend(args, device, logger) -> dict:
    from davo_tpu_torch.train import fit_frontend, save_frontend_checkpoint

    config = _frontend_config(args)
    state, history = fit_frontend(config, log_fn=logger, device=device)
    if args.checkpoint_dir:
        path = save_frontend_checkpoint(args.checkpoint_dir, len(history["train"]), state.network, config)
        print(f"checkpoint: {path}", flush=True)
    return {"final": history["val"][-1] if history["val"] else history["train"][-1]}


def run(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv`` and run the subcommand; returns what :func:`main`
    prints last."""
    args = _build_parser().parse_args(argv)
    from davo_tpu_torch.models import load_flax_weights
    from davo_tpu_torch.train import (
        MetricsLogger,
        batch_generator,
        evaluate_calibration_ate,
        fit,
        get_preset,
        latest_step,
        make_eval_step,
        restore_checkpoint,
    )
    from davo_tpu_torch.utils.device import resolve_device

    if args.platform is not None and args.platform not in _PLATFORMS:
        raise ValueError(f"--platform must be one of {sorted(_PLATFORMS)}, got {args.platform!r}")
    device = resolve_device(None if args.platform is None else _PLATFORMS[args.platform])
    logger = MetricsLogger(args.metrics_file, tensorboard_dir=args.tensorboard_dir)
    if args.command == "fit-frontend":
        return _fit_frontend(args, device, logger)
    config = _apply_overrides(get_preset(args.preset), args)

    if args.command == "fit":
        _, history = fit(config, log_fn=logger, checkpoint_dir=args.checkpoint_dir, device=device)
        if args.checkpoint_dir:
            step = latest_step(args.checkpoint_dir)
            print(f"checkpoint: {os.path.join(os.path.abspath(args.checkpoint_dir), f'checkpoint_{step}.pkl')}", flush=True)
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
    result.update(evaluate_calibration_ate(network, config, config.seed, batches=4))
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    print(json.dumps(run(argv)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
