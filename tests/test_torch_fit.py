"""``fit``, its checkpoints and the ``fit`` and ``eval`` entries on the CPU.

* ``fit`` on a tiny experiment (3 views x 4 points, hidden 16, batch 4,
  float64, a 2-iteration unrolled solve with drop-path) logs finite
  metrics under the JAX package's names.
* Checkpoint and resume: 1 + 1 epochs through ``checkpoint_dir`` equal 2
  uninterrupted epochs exactly (the same history, parameters, running
  statistics and Adam moments), as ``tests/train/test_fit_resume.py``
  asks of the JAX package.
* A curriculum killed in its second stage resumes there (global epochs
  2 and 3), as ``tests/train/test_fit_resume.py::
  test_curriculum_cross_stage_resume``.
* A checkpoint the port writes is read by the JAX package's own
  ``restore_checkpoint``, and the JAX network's guess head gives the
  port's guesses from it (1e-10, float64), for the MLP head (with its
  running statistics) and the transformer head.
* ``python -m davo_tpu_torch.cli fit --platform cpu`` (also with
  ``--solver lbfgs``: the unrolled L-BFGS solve in the train steps) and
  ``eval --selection basin --restart-proposals permutation --platform
  cpu`` run.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.models.calibration_network import CalibrationMLPHead as JMLPHead
from davo_tpu.models.calibration_network import CalibrationTransformerHead as JTransformerHead
from davo_tpu.train import restore_checkpoint as j_restore_checkpoint
from davo_tpu_torch import cli
from davo_tpu_torch.data import SceneConfig, generate_batch
from davo_tpu_torch.solve import BFGSConfig
from davo_tpu_torch.train import (
    CalibrationExperiment,
    MetricsLogger,
    fit,
    fit_fov_curriculum,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from davo_tpu_torch.train.calibration import train_state_tree
from tests.test_torch_eval_entry import TINY_ARGS, _tiny_preset
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def _config(**fields):
    defaults = dict(
        num_views=3, num_points=4, hidden_size=16, batch_size=4, batches_per_epoch=2, val_batches=1, epochs=2,
        dtype=torch.float64,
        solver=BFGSConfig(iterations=3, training_iterations=2, line_search_iterations=6, drop_path_p=0.3),
    )
    return CalibrationExperiment(**{**defaults, **fields})


def test_fit_logs_finite_metrics(tmp_path):
    path = tmp_path / "metrics.jsonl"
    state, history = fit(_config(epochs=1), log_fn=MetricsLogger(str(path)), device="cpu")
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [(r["split"], r["epoch"]) for r in records] == [("train", 0), ("val", 0)]
    names = {"loss", "mean_error", "focal_length_loss", "cx_loss", "cy_loss", "structure_loss"}
    assert names <= set(history["train"][0]) and names == set(history["val"][0])
    assert all(np.isfinite(v) for r in records for k, v in r.items() if k not in ("split", "epoch"))
    assert state.step == 2
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        MetricsLogger(tensorboard_dir=str(tmp_path / "tb"))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


def test_resume_equals_an_uninterrupted_run(tmp_path):
    config = _config()
    whole_state, whole = fit(config, device="cpu", checkpoint_dir=str(tmp_path / "whole"))
    fit(config, epochs=1, device="cpu", checkpoint_dir=str(tmp_path / "split"))
    assert latest_step(str(tmp_path / "split")) == 1
    resumed_state, resumed = fit(config, device="cpu", checkpoint_dir=str(tmp_path / "split"))
    assert len(resumed["train"]) == 1 and resumed_state.step == whole_state.step == 4
    for split in ("train", "val"):
        got = {k: v for k, v in resumed[split][0].items() if k != "epoch_seconds"}
        assert got == {k: v for k, v in whole[split][1].items() if k != "epoch_seconds"}
    want, got = _flat(train_state_tree(whole_state)), _flat(train_state_tree(resumed_state))
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert np.abs(want["/opt_state/mu/initial_estimator/head/kernel"]).max() > 0  # the moments round-tripped
    # a save interrupted before its rename is not a checkpoint
    (tmp_path / "split" / "checkpoint_9.pkl.tmp").write_bytes(b"")
    assert latest_step(str(tmp_path / "split")) == 2


def test_curriculum_cross_stage_resume(tmp_path):
    config = _config(epochs=4)
    stages = ((40.0, 60.0, 2), (30.0, 120.0, 2))

    class Kill(Exception):
        pass

    def killing_log(split, epoch, metrics):
        if split == "train" and epoch == 2:  # the first epoch of stage 1
            raise Kill()

    with pytest.raises(Kill):
        fit_fov_curriculum(config, stages, log_fn=killing_log, checkpoint_dir=str(tmp_path), checkpoint_every=1,
                           device="cpu")
    seen = []
    state, history = fit_fov_curriculum(config, stages, log_fn=lambda s, e, m: seen.append((s, e)),
                                        checkpoint_dir=str(tmp_path), checkpoint_every=1, device="cpu")
    assert [e for s, e in seen if s == "train"] == [2, 3]
    assert state.step == 4 * config.batches_per_epoch
    assert len(history["train"]) == 2
    with pytest.raises(ValueError, match="beyond this stage"):
        fit(config, epochs=1, device="cpu", checkpoint_dir=str(tmp_path))


@pytest.mark.parametrize(
    "setting",
    [dict(head="mlp", hidden_size=16), dict(head="transformer", hidden_size=16, transformer_layers=1,
                                           transformer_heads=2)],
    ids=["mlp", "transformer"],
)
def test_port_checkpoint_restores_in_jax(tmp_path, setting):
    config = dataclasses.replace(_config(epochs=1), **setting)
    state, _ = fit(config, device="cpu", checkpoint_dir=str(tmp_path))
    restored = j_restore_checkpoint(str(tmp_path))
    assert int(restored["step"]) == 2 and set(restored) == {"params", "batch_stats", "opt_state", "step"}
    ours = _flat(restore_checkpoint(str(tmp_path)))
    assert ours.keys() == _flat(restored).keys()
    for key, value in _flat(restored).items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)
    scenes = generate_batch(torch.Generator().manual_seed(3), 5, SceneConfig(num_views=3, num_points=4,
                                                                            dtype=torch.float64), device="cpu")
    pts, vis = (jnp.asarray(x.numpy()) for x in (scenes.projected_points, scenes.visibility_mask))
    p = 3 + 3 * 4 + 6 * 2
    if setting["head"] == "mlp":
        j_head = JMLPHead(num_outputs=p, hidden_size=16)
        inputs = (pts.reshape(pts.shape[0], -1),)
    else:
        j_head = JTransformerHead(num_outputs=p, num_views=3, num_points=4, embed_dim=16, num_layers=1, num_heads=2)
        inputs = (pts, vis)
    variables = {"params": restored["params"]["initial_estimator"]}
    if restored["batch_stats"]:
        variables["batch_stats"] = restored["batch_stats"]["initial_estimator"]
    j_guess = jax.jit(j_head.apply)(variables, *inputs)
    guess = state.network.guess(scenes.projected_points, scenes.visibility_mask).numpy()
    np.testing.assert_allclose(guess, np.asarray(j_guess), rtol=1e-10, atol=1e-10)


def test_save_checkpoint_writes_numpy(tmp_path):
    path = save_checkpoint(str(tmp_path), 3, {"params": {"w": torch.ones(2)}, "step": 3})
    assert path.endswith("checkpoint_3.pkl")
    restored = restore_checkpoint(str(tmp_path))
    assert isinstance(restored["params"]["w"], np.ndarray) and restored["step"] == 3


FIT_ARGS = [
    "fit", "--platform", "cpu", "--preset", "calibration_from_oracle_matches", "--epochs", "1",
    "--batches-per-epoch", "1", "--val-batches", "1", "--batch-size", "4", "--hidden-size", "16",
]


def test_cli_fit_on_the_cpu(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    assert cli.main(FIT_ARGS + ["--checkpoint-dir", str(tmp_path), "--metrics-file", str(metrics)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    final = json.loads(lines[-1])["final_val"]
    assert set(final) >= {"loss", "mean_error", "focal_length_loss"} and all(np.isfinite(list(final.values())))
    assert lines[-2].startswith("checkpoint: ") and latest_step(str(tmp_path)) == 1
    assert len(metrics.read_text().splitlines()) == 2


def test_cli_fit_lbfgs_on_the_cpu(monkeypatch, capsys):
    """``fit --solver lbfgs``: the train steps run the differentiable
    L-BFGS unroll, the validation its eval solve."""
    from davo_tpu_torch.models import calibration_network

    modes = []
    original = calibration_network.lbfgs_solve

    def spy(*args, **kwargs):
        modes.append(kwargs.get("training", False))
        return original(*args, **kwargs)

    monkeypatch.setattr(calibration_network, "lbfgs_solve", spy)
    assert cli.main(FIT_ARGS + ["--solver", "lbfgs", "--lbfgs-history", "4"]) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final_val"]
    assert set(final) >= {"loss", "mean_error"} and all(np.isfinite(list(final.values())))
    assert True in modes and False in modes


def test_cli_fit_resumes_from_its_checkpoint_dir(tmp_path, capsys):
    """``fit --epochs 1`` then ``fit --epochs 2`` on one directory resumes
    from the whole state that ``fit`` saved and ends where ``--epochs 2``
    from scratch ends (the directory has one writer)."""

    def final(directory, epochs):
        argv = FIT_ARGS[:FIT_ARGS.index("--epochs") + 1] + [str(epochs)] + FIT_ARGS[FIT_ARGS.index("--epochs") + 2 :]
        assert cli.main(argv + ["--checkpoint-dir", str(directory)]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines[-2] == f"checkpoint: {directory / f'checkpoint_{epochs}.pkl'}"
        assert {"params", "batch_stats", "opt_state", "step"} <= set(restore_checkpoint(str(directory), epochs))
        return {k: v for k, v in json.loads(lines[-1])["final_val"].items() if k != "epoch_seconds"}

    final(tmp_path / "split", 1)
    resumed = final(tmp_path / "split", 2)
    assert latest_step(str(tmp_path / "split")) == 2
    assert resumed == final(tmp_path / "whole", 2)


def test_cli_eval_basin_permutation_on_the_cpu(monkeypatch, capsys):
    _tiny_preset(monkeypatch)
    args = TINY_ARGS + ["--selection", "basin", "--restart-proposals", "permutation", "--basin-anchor", "0.5"]
    assert cli.main(args) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"ate_rmse_mean", "f_error_mean", "loss"} <= set(printed)
    assert all(np.isfinite(v) for v in printed.values())
