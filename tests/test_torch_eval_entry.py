"""The ``eval`` entry: the checkpoint loader, the eval step and the
trajectory accuracy against the JAX package's, and the port's CLI.

* Loader: the arrays ``load_numpy_checkpoint`` reads, without JAX, from
  the pickles of JAX arrays (``calibration_transformer_v4_1800.pkl`` and
  ``_v3_1200.pkl``) equal, exactly, the arrays of JAX's own
  ``pickle.load``.
* ``make_eval_step`` and ``evaluate_calibration_ate`` on the same injected
  batch (8 scenes drawn by the JAX package), with a tiny transformer (2
  layers, width 32) whose JAX weights ``convert.py`` carries across, one
  start and a 10-iteration solve, float64: every metric to 1e-6 relative
  (rounding compounds over the solve, as in
  ``test_torch_calibration_network.py``).  The JAX side's fused objective
  is the function its Pallas kernel computes (the polynomial atan2), the
  port's too.
* ``_winner_take_all_loss`` (multi-token guesses) to 1e-12 on the same
  arrays.
* ``python -m davo_tpu_torch.cli eval --platform cpu`` at a tiny size
  (a checkpoint of the tiny network, 2 restarts, a 3-iteration solve):
  control flow and finite metrics; ``--solver lbfgs --lbfgs-history 5``
  converts the preset's solver as the JAX CLI's ``_apply_overrides``
  does and runs; the refusals of what is still not ported.
"""

import dataclasses
import json
import pickle
from pathlib import Path
from types import SimpleNamespace
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import davo_tpu.models.calibration_network as j_network_module
from davo_tpu.data import SceneConfig as JSceneConfig
from davo_tpu.data import generate_batch as j_generate_batch
from davo_tpu.models import CalibrationNetwork as JNetwork
from davo_tpu.solve import BFGSConfig as JBFGSConfig
from davo_tpu.train import calibration as jc
from davo_tpu.train import save_checkpoint as j_save_checkpoint
from davo_tpu_torch import cli
from davo_tpu_torch.models import CalibrationNetwork, flax_to_state_dict, load_numpy_checkpoint
from davo_tpu_torch.solve import BFGSConfig, LBFGSConfig
from davo_tpu_torch.train import calibration as tc
from davo_tpu_torch.train import presets, restore_checkpoint
from davo_tpu_torch.types import CameraViewsAndPoints
from tests.test_torch_calibration_network import _kernel_function_objective
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
M, N = 4, 8
P = 3 + 3 * N + 6 * (M - 1)
TINY = dict(num_views=M, num_points=N, hidden_size=32, head="transformer", transformer_layers=2, transformer_heads=4)
SOLVER = dict(error_threshold=1e-7, iterations=10, line_search_iterations=50)


class _State(NamedTuple):
    """What the JAX eval reads of a train state (a pytree, for its jit)."""

    params: Any
    batch_stats: Any


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            out.update(_flatten(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("name", ["calibration_transformer_v4_1800.pkl", "calibration_transformer_v3_1200.pkl"])
def test_loader_reads_jax_array_pickles(name):
    path = REPO / "artifacts" / name
    with open(path, "rb") as f:
        expected = _flatten(pickle.load(f))
    got = _flatten(load_numpy_checkpoint(path))
    assert got.keys() == expected.keys()
    for key, value in expected.items():
        assert isinstance(got[key], np.ndarray) and got[key].dtype == value.dtype
        np.testing.assert_array_equal(got[key], value, err_msg=key)


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX network (its fused objective the Pallas kernel's
    function), its float64 weights and 8 scenes drawn by the JAX package."""
    scenes = jax.jit(lambda k: j_generate_batch(k, 8, JSceneConfig(dtype=jnp.float64)))(jax.random.key(11))
    net = JNetwork(solver=JBFGSConfig(**SOLVER), fused_objective=True, **TINY)
    variables = net.init(jax.random.key(12), scenes.projected_points, scenes.visibility_mask)
    params = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), variables["params"])
    return net, params, scenes


def _injected(config_type, batch_fn, **fields):
    """An experiment whose ``make_batch_fn`` serves one fixed batch."""

    class Injected(config_type):
        def make_batch_fn(self, *_):
            return batch_fn

    return Injected(**fields)


def _port_network_and_config(params, scenes):
    batch = CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in scenes))
    config = _injected(
        tc.CalibrationExperiment, lambda *_: batch, batch_size=8, dtype=torch.float64,
        solver=BFGSConfig(**SOLVER), **TINY,
    )
    network = config.build_network("cpu")
    network.load_state_dict(flax_to_state_dict(params))
    return network, config


def test_eval_step_and_ate_match_jax(tiny, monkeypatch):
    monkeypatch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
    j_net, params, scenes = tiny
    j_config = _injected(
        jc.CalibrationExperiment, lambda *_: scenes, batch_size=8, dtype=jnp.float64,
        solver=JBFGSConfig(**SOLVER), **TINY,
    )
    state = _State(params=params, batch_stats={})
    j_metrics = jc.make_eval_step(j_net, j_config)(state, jax.random.key(0))
    j_ate = jc.evaluate_calibration_ate(j_net, state, j_config, jax.random.key(0), batches=1)

    network, config = _port_network_and_config(params, scenes)
    metrics = tc.make_eval_step(network, config)(torch.Generator())
    ate = tc.evaluate_calibration_ate(network, config, seed=0, batches=1)
    assert set(metrics) == set(j_metrics) and set(ate) == set(j_ate)
    for name, value in j_metrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), rtol=1e-6, err_msg=name)
    for name, value in j_ate.items():
        np.testing.assert_allclose(ate[name], value, rtol=1e-6, err_msg=name)


def test_winner_take_all_loss_matches_jax(tiny):
    j_net, _, scenes = tiny
    rng = np.random.default_rng(5)
    predictions = rng.normal(size=(8, 3, P))
    error = rng.random((8, 3))
    j_loss, j_metrics = jc._winner_take_all_loss(
        SimpleNamespace(num_views=M, num_points=N), jnp.asarray(predictions), jnp.asarray(error), scenes, 1.0
    )
    batch = CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in scenes))
    loss, metrics = tc._winner_take_all_loss(
        SimpleNamespace(num_views=M, num_points=N), torch.tensor(predictions), torch.tensor(error), batch, 1.0
    )
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-12)
    assert set(metrics) == set(j_metrics)
    for name, value in j_metrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), rtol=1e-12, atol=1e-15, err_msg=name)


def _tiny_preset(monkeypatch):
    """The transformer preset with a 3-iteration solve (the tiny size)."""
    original = presets.PRESETS["calibration_transformer_curriculum"]
    monkeypatch.setitem(
        presets.PRESETS, "calibration_transformer_curriculum",
        lambda: dataclasses.replace(original(), solver=BFGSConfig(error_threshold=1e-7, iterations=3)),
    )


TINY_ARGS = [
    "eval", "--platform", "cpu", "--preset", "calibration_transformer_curriculum", "--hidden-size", "32",
    "--transformer-layers", "2", "--transformer-heads", "4", "--restarts", "2", "--batch-size", "4",
    "--batches", "1",
]


def test_cli_eval_on_the_cpu(tiny, tmp_path, monkeypatch, capsys):
    _, params, _ = tiny
    j_save_checkpoint(str(tmp_path), 7, {"params": params, "batch_stats": {}}, format="pickle")
    assert restore_checkpoint(str(tmp_path))["params"].keys() == params.keys()
    _tiny_preset(monkeypatch)
    assert cli.main(TINY_ARGS + ["--checkpoint-dir", str(tmp_path)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {
        "loss", "mean_error", "focal_length_loss", "cx_loss", "cy_loss", "structure_loss",
        "ate_rmse_mean", "ate_rmse_median", "f_error_mean", "centre_error_mean",
    }
    assert all(np.isfinite(v) for v in printed.values())


@pytest.mark.parametrize(
    "extra,match",
    [
        (["--config", "experiment.yaml"], "Queue 1 item 8"),
        (["--tensorboard-dir", "tb"], "Queue 1 item 8"),
        (["--preset", "bfgs_solver_full_gradient"], "Queue 1 item 6"),
    ],
)
def test_cli_refuses_what_is_not_ported(extra, match):
    """What the entry still refuses (basin selection and the permutation,
    input-noise and token proposals run: ``tests/test_torch_fit.py``)."""
    with pytest.raises(NotImplementedError, match=match):
        cli.run(TINY_ARGS + extra)


@pytest.mark.parametrize(
    "preset,history",
    [("calibration_transformer_curriculum", "5"), ("calibration_from_oracle_matches", None)],
    ids=["curriculum_history_5", "oracle_default_history"],
)
def test_lbfgs_override_converts_as_jax_does(preset, history):
    """``--solver lbfgs`` carries the fields the preset's BFGS config shares
    with ``LBFGSConfig`` over and takes the memory from
    ``--lbfgs-history``, as ``davo_tpu/cli.py::_apply_overrides``."""
    from davo_tpu import cli as j_cli
    from davo_tpu.train import get_preset as j_get_preset

    argv = ["eval", "--preset", preset, "--solver", "lbfgs"] + (["--lbfgs-history", history] if history else [])
    args = cli._build_parser().parse_args(argv)
    config = cli._apply_overrides(presets.get_preset(preset), args)
    j_config = j_cli._apply_overrides(j_get_preset(preset), args)
    assert type(config.solver).__name__ == type(j_config.solver).__name__ == "LBFGSConfig"
    assert dataclasses.asdict(config.solver) == dataclasses.asdict(j_config.solver)
    assert config.solver.history == (int(history) if history else 10)


def test_cli_eval_lbfgs_on_the_cpu(monkeypatch, capsys):
    """``eval --solver lbfgs --lbfgs-history 5`` at the tiny size: the
    network's solves run L-BFGS (history 5) and the metrics are finite."""
    _tiny_preset(monkeypatch)
    solvers = []
    original = CalibrationNetwork._solve

    def spy(self, *args, **kwargs):
        solvers.append(self.solver)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(CalibrationNetwork, "_solve", spy)
    assert cli.main(TINY_ARGS + ["--solver", "lbfgs", "--lbfgs-history", "5"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"ate_rmse_mean", "f_error_mean", "loss"} <= set(printed)
    assert all(np.isfinite(v) for v in printed.values())
    assert solvers and all(isinstance(s, LBFGSConfig) and s.history == 5 and s.iterations == 3 for s in solvers)


def test_checkpoint_and_preset_refusals(tmp_path):
    (tmp_path / "checkpoint_5").mkdir()  # an Orbax checkpoint directory
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        restore_checkpoint(str(tmp_path))
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        presets.get_preset("mlp_guess")
    with pytest.raises(KeyError):
        presets.get_preset("no_such_preset")
