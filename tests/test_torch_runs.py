"""The run infrastructure: the run registry, YAML configs, the metrics
logger's provenance and TensorBoard mirror, ``weight_summaries`` and the
``presets``/``runs``/``fit --config`` commands, against the JAX package's.

* A manifest registered by each package is read back by the other's
  ``load_registry``, ``final_metrics`` and ``compare_runs`` (one registry,
  the JAX package's format), with equal results from both.
* Every ``configurations/*.yaml`` gives the same config in both packages
  (every field; the dtype names the framework's own float32).
* ``MetricsLogger``: the JSONL starts with the ``{"run": manifest}``
  header and each record carries the ``run_id``, as the JAX logger
  writes them; the TensorBoard event file holds each ``<split>/<name>``
  scalar at its epoch.
* ``weight_summaries`` of the port's front end, converted to the flax
  tree, equals the JAX function's on the JAX weights (float64, 1e-12).
* ``python -m davo_tpu_torch.cli presets`` prints the JAX CLI's lines;
  ``fit --config`` (a YAML of ``configurations/``, cut to a tiny size)
  registers its run, prints its ``run_id`` line, and ``runs
  list|show|compare`` of both CLIs read it back.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu import cli as j_cli
from davo_tpu.train import load_config_yaml as j_load_config_yaml
from davo_tpu.train import weight_summaries as j_weight_summaries
from davo_tpu.train import runs as j_runs
from davo_tpu.train.metrics import MetricsLogger as JMetricsLogger
from davo_tpu_torch import cli
from davo_tpu_torch.models import FRONTEND_V4, load_frontend, load_frontend_npz
from davo_tpu_torch.models.convert import frontend_state_to_flax
from davo_tpu_torch.train import MetricsLogger, load_config_yaml, weight_summaries
from davo_tpu_torch.train import runs as t_runs
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configurations", "*.yaml")))


def _log_run(runs, logger_cls, tmp_path, tag, config, checkpoint=True):
    """Register a run of ``config`` by ``runs`` and log two epochs with
    ``logger_cls`` to its metrics file (named in the manifest's argv)."""
    metrics = str(tmp_path / f"{tag}.jsonl")
    manifest = runs.make_run_manifest(config, name=tag, tags={"command": "fit"})
    manifest["argv"] = ["fit", "--metrics-file", metrics]
    ckpt = str(tmp_path / f"ckpt_{tag}") if checkpoint else None
    runs.register_run(manifest, registry_dir=str(tmp_path / "runs"), checkpoint_dir=ckpt)
    logger = logger_cls(metrics, run=manifest)
    for epoch, loss in enumerate((2.0, 1.0 if tag == "port" else 1.5)):
        logger("train", epoch, {"loss": loss + 1.0})
        logger("val", epoch, {"loss": loss, "mean_error": loss / 2})
    return manifest, metrics


def test_each_package_reads_the_others_registry(tmp_path):
    j_manifest, _ = _log_run(j_runs, JMetricsLogger, tmp_path, "jax", j_load_config_yaml(CONFIGS[0]))
    t_manifest, _ = _log_run(t_runs, MetricsLogger, tmp_path, "port", load_config_yaml(CONFIGS[1]))
    assert t_manifest["backend"] in ("cuda", "cpu") and isinstance(t_manifest["num_devices"], int)
    assert set(t_manifest) == set(j_manifest)
    registry = str(tmp_path / "runs")
    j_rows, t_rows = j_runs.load_registry(registry), t_runs.load_registry(registry)
    assert j_rows == t_rows and [r["run_id"] for r in t_rows] == [j_manifest["run_id"], t_manifest["run_id"]]
    assert "config" not in t_rows[1]  # the registry line leaves the config out
    for row in t_rows:
        assert t_runs.final_metrics(row) == j_runs.final_metrics(row)
    assert t_runs.final_metrics(t_rows[1])["val"] == {"loss": 1.0, "mean_error": 0.5, "elapsed_s": pytest.approx(
        t_runs.final_metrics(t_rows[1])["val"]["elapsed_s"]), "epoch": 1}
    compared = t_runs.compare_runs(t_rows)
    assert compared == j_runs.compare_runs(j_rows)
    assert compared["metrics"]["loss"] == {j_manifest["run_id"]: 1.5, t_manifest["run_id"]: 1.0}
    assert "solver.iterations" in compared["config_diff"]  # the two YAMLs' solvers differ
    assert t_runs.config_to_jsonable(load_config_yaml(CONFIGS[1]))["solver"] == json.loads(
        open(tmp_path / "ckpt_port" / "run_manifest.json").read())["config"]["solver"]


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_yaml_configs_load_alike(path):
    want = j_runs.config_to_jsonable(j_load_config_yaml(path))
    got = t_runs.config_to_jsonable(load_config_yaml(path))
    assert want.pop("dtype").endswith("float32'>") and got.pop("dtype") == "torch.float32"
    assert got == want


def test_config_mapping_refuses_unknown_fields(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("preset: mlp_guess\nsolver:\n  iterations: 3\n  no_such_field: 1\n")
    with pytest.raises(KeyError, match="no_such_field"):
        load_config_yaml(str(path))


def test_metrics_logger_header_run_id_and_tensorboard(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    manifest = t_runs.make_run_manifest({"a": 1}, name="t")
    path, tb = tmp_path / "m.jsonl", tmp_path / "tb"
    logger = MetricsLogger(str(path), tensorboard_dir=str(tb), run=manifest)
    logger("train", 0, {"loss": 3.0, "mean_error": 1.5})
    logger("val", 1, {"loss": 2.0})
    logger.close()
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert records[0] == {"run": manifest}
    assert [r["run_id"] for r in records[1:]] == [manifest["run_id"]] * 2
    events = EventAccumulator(str(tb))
    events.Reload()
    assert set(events.Tags()["scalars"]) == {"train/loss", "train/mean_error", "val/loss"}
    assert [(e.step, e.value) for e in events.Scalars("train/mean_error")] == [(0, 1.5)]
    assert [(e.step, e.value) for e in events.Scalars("val/loss")] == [(1, 2.0)]


def test_weight_summaries_match_jax():
    tree = load_frontend_npz(FRONTEND_V4)
    j_params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree["params"])
    want = j_weight_summaries(j_params)
    frontend, _ = load_frontend(device="cpu", dtype=torch.float64)
    got = weight_summaries(frontend_state_to_flax(frontend.state_dict())[0])
    assert got.keys() == want.keys() and "matcher/query/kernel" in got
    for name in want:
        for stat in ("mean", "std", "absmax"):
            assert got[name][stat] == pytest.approx(want[name][stat], rel=1e-12, abs=1e-12), (name, stat)
    # a state_dict's dotted names become paths
    assert set(weight_summaries(frontend.matcher.state_dict())) == {"query/weight", "query/bias", "key/weight",
                                                                    "key/bias"}


def test_cli_presets_lists_the_jax_presets(capsys):
    assert j_cli.main(["presets"]) == 0
    want = capsys.readouterr().out
    assert cli.main(["presets"]) == 0
    assert capsys.readouterr().out == want


def test_cli_fit_config_registers_and_runs_reads_back(tmp_path, capsys):
    registry, metrics = str(tmp_path / "runs"), str(tmp_path / "m.jsonl")
    argv = ["fit", "--platform", "cpu", "--config", CONFIGS[-1], "--epochs", "1", "--batches-per-epoch", "2",
            "--batch-size", "8", "--hidden-size", "16", "--registry-dir", registry, "--metrics-file", metrics,
            "--checkpoint-dir", str(tmp_path / "ckpt")]
    assert os.path.basename(CONFIGS[-1]) == "mlp_guess_config.yaml"
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    run_line = json.loads(lines[0])
    assert set(run_line) == {"run_id", "config_hash", "git_sha"}
    assert "final_train" in json.loads(lines[-1])
    row, = t_runs.load_registry(registry)
    assert row["run_id"] == run_line["run_id"] and row["name"] == CONFIGS[-1]
    assert row["tags"] == {"command": "fit"} and row["checkpoint_dir"] == str(tmp_path / "ckpt")
    assert json.loads(open(metrics).readline())["run"]["config"]["hidden_size"] == 16
    for main in (cli.main, j_cli.main):
        assert main(["runs", "list", "--registry-dir", registry]) == 0
        listed = json.loads(capsys.readouterr().out)
        assert listed["run_id"] == run_line["run_id"] and listed["backend"] == "cpu"
        assert listed["final_loss"] == pytest.approx(json.loads(lines[-1])["final_train"]["loss"], rel=1e-6)
    assert cli.main(["runs", "show", run_line["run_id"][:17], "--registry-dir", registry]) == 0
    shown = json.loads(capsys.readouterr().out)
    assert shown["metrics_file"] == metrics and set(shown["final_metrics"]) == {"train"}
    assert cli.main(["runs", "compare", "--registry-dir", registry, "--split", "train"]) == 0
    assert set(json.loads(capsys.readouterr().out)["metrics"]["loss"]) == {run_line["run_id"]}
    assert cli.main(["runs", "show", "no-such-run", "--registry-dir", registry]) == 1
    assert cli.main(["runs", "show", "--registry-dir", registry]) == 2
    assert cli.main(["runs", "list", "--registry-dir", str(tmp_path / "empty")]) == 1
