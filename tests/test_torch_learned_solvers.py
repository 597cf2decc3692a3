"""The learned solvers' networks against the JAX package's, float64.

* The forward of each solver type at a small width (3 views x 4 points,
  P = 27, 8 JAX-drawn scenes, starts truth + 0.3 normal, two steps):
  ``MLPSolver`` (recurrent and not: eval, and training with its BatchNorm
  statistics moved once a step), ``TransformerSolver`` (width 16, 2
  heads, its history growing a step) and ``SearchDirectionHeuristic`` (eval and
  training), from the JAX package's initial weights carried across by
  ``learned_solver_state_dict``: every step of the trajectory and the
  moved statistics to 1e-10 relative (the plain calibration objective is
  the same function in both, exact atan2 included); the reverse map
  gives back the flax tree.
* ``artifacts/learned_solver_descent_v2.pkl``: the port's loader reads it
  without JAX (its config names ``jax.numpy.float32``, read as numpy's
  ``float32``) to the arrays of JAX's own ``pickle.load``, exactly; the
  loaded solver's forward on 16 JAX-drawn starts (the JAX experiment's
  ``_make_problem`` at the checkpoint's config) equals the JAX network's
  in float64: the first three steps to 1e-10; the trained solver
  diverges on such starts (as in the JAX log), so rounding grows 10-1000
  times a step and each step's objective is held to 100 times the growth
  read (1e-12 to 1e-4 relative).
"""

import dataclasses
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import davo_tpu.train.learned_solver as jl
from davo_tpu.camera import calibration_error as j_calibration_error
from davo_tpu.data import SceneConfig as JSceneConfig
from davo_tpu_torch import models as tm
from davo_tpu_torch.data import SceneConfig
from davo_tpu_torch.models import load_numpy_checkpoint
from davo_tpu_torch.train import LearnedSolverExperiment, load_learned_solver, make_problem
from davo_tpu_torch.types import CameraViewsAndPoints
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

CHECKPOINT = Path(__file__).resolve().parents[1] / "artifacts" / "learned_solver_descent_v2.pkl"
TINY = dict(num_views=3, num_points=4, hidden_size=16, embed_dim=16, num_heads=2, num_steps=2, start_noise=0.3,
            batch_size=8)
VARIANTS = {
    "mlp_recurrent": dict(solver_type="mlp"),
    "mlp": dict(solver_type="mlp", recurrent=False),
    "transformer": dict(solver_type="transformer", recurrent=False),
    "direction": dict(solver_type="direction"),
}


def _close(actual, expected, tol, name=""):
    actual, expected = to_numpy(actual), np.asarray(expected)
    scale = max(float(np.max(np.abs(expected))), 1e-300)
    np.testing.assert_allclose(actual, expected, rtol=tol, atol=tol * scale, err_msg=name)


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


def _to64(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def jax_problem(j_config, key):
    """The JAX experiment's problem for ``key`` (its ``_make_problem``,
    jitted: the objective is rebuilt outside as the experiment builds it),
    and the port's scenes and start draws for the same problem."""

    def draws(k):
        batch, truth, starts, _ = jl._make_problem(j_config, k)
        _, k_noise = jax.random.split(k)
        return batch, truth, starts, jax.random.normal(k_noise, truth.shape, truth.dtype)

    batch, truth, starts, noise = jax.jit(draws)(key)
    visibility = batch.visibility_mask.astype(truth.dtype)

    def error_fn(parameters):
        return j_calibration_error(parameters, batch.projected_points[:, None], visibility[:, None])

    t_batch = CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in batch))
    return (batch, truth, starts, error_fn), t_batch, torch.tensor(np.asarray(noise))


def configs(**fields):
    """The JAX and the port's experiments with ``fields``, float64 scenes."""
    j_config = jl.LearnedSolverExperiment(scene=JSceneConfig(dtype=jnp.float64), **fields)
    t_config = LearnedSolverExperiment(scene=SceneConfig(dtype=torch.float64), **fields)
    return j_config, t_config


def jax_variables(network, j_config, starts, error_fn):
    if j_config.solver_type == "direction":
        return _to64(jax.jit(lambda k, s: network.init(k, s[:, 0, :], jnp.zeros(()), training=False))(
            jax.random.key(3), starts))
    return _to64(jax.jit(lambda k, s: network.init(k, s, error_fn, training=False))(jax.random.key(3), starts))


@pytest.fixture(scope="module")
def tiny_problem():
    """The small size's problem (the same for every solver type)."""
    return jax_problem(configs(**TINY)[0], jax.random.key(41))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_solver_forward_matches_jax(variant, tiny_problem):
    j_config, t_config = configs(**TINY, **VARIANTS[variant])
    (j_batch, _, j_starts, j_error_fn), t_batch, noise = tiny_problem
    _, _, t_starts, t_error_fn = make_problem(t_config, t_batch, noise)
    _close(t_starts, j_starts, 1e-15, "starts")  # XLA may fuse truth + 0.3 noise (one rounding)
    network = j_config.build_network()
    variables = jax_variables(network, j_config, j_starts, j_error_fn)
    t_net = t_config.build_network("cpu")
    tm.load_flax_tree(t_net, variables["params"], variables.get("batch_stats"))
    heads = j_config.num_heads if j_config.solver_type == "transformer" else None
    params, stats = tm.learned_solver_to_flax(t_net.state_dict(), num_heads=heads)
    assert _flat(params).keys() == _flat(variables["params"]).keys()
    assert all(np.array_equal(_flat(params)[k], v) for k, v in _flat(variables["params"]).items())

    trains = (False, True) if j_config.solver_type in ("mlp", "direction") else (False,)
    for training in trains:
        mutable = ["batch_stats"] if training else False
        if j_config.solver_type == "direction":
            direction = np.random.default_rng(5).normal(size=(8, j_config.num_parameters))
            j_out = jax.jit(lambda v, d: network.apply(v, d, 3, training=training, mutable=mutable))(
                variables, jnp.asarray(direction))
            t_out = t_net(torch.tensor(direction), 3, training=training)
        else:
            j_out = jax.jit(lambda v, s: network.apply(v, s, j_error_fn, training=training, return_trajectory=True,
                                                       mutable=mutable))(variables, j_starts)
            t_out = t_net(t_starts, t_error_fn, training=training, return_trajectory=True)
        j_out, mutated = j_out if training else (j_out, None)
        assert tuple(t_out.shape) == tuple(j_out.shape)
        _close(t_out.detach(), j_out, 1e-10, f"training={training} output")
        if mutated is not None:
            moved = _flat(tm.learned_solver_to_flax(t_net.state_dict())[1])
            for key, value in _flat(mutated["batch_stats"]).items():
                _close(moved[key], value, 1e-10, f"batch_stats {key}")
            assert not all(np.allclose(v, 0.0) for k, v in moved.items() if k.endswith("mean"))


def test_v2_checkpoint_loads_without_jax_and_matches_jax_forward():
    with open(CHECKPOINT, "rb") as f:
        j_checkpoint = pickle.load(f)
    ours = load_numpy_checkpoint(CHECKPOINT)
    for tree in ("params", "batch_stats"):
        theirs = _flat(j_checkpoint[tree])
        assert _flat(ours[tree]).keys() == theirs.keys()
        assert all(np.array_equal(_flat(ours[tree])[k], np.asarray(v)) for k, v in theirs.items())
    assert ours["config"]["scene"]["dtype"] is np.float32
    assert {k: v for k, v in ours["config"].items() if k != "scene"} == {
        k: v for k, v in j_checkpoint["config"].items() if k != "scene"}

    net, config = load_learned_solver(CHECKPOINT, device="cpu")
    assert (config.solver_type, config.num_steps, config.recurrent, config.hidden_size) == ("mlp", 5, True, 256)
    assert config.scene.dtype == torch.float32
    net = net.double()
    fields = {k: v for k, v in j_checkpoint["config"].items() if k != "scene"}
    j_config = jl.LearnedSolverExperiment(**dict(fields, batch_size=16), scene=JSceneConfig(dtype=jnp.float64))
    (_, _, j_starts, j_error_fn), t_batch, noise = jax_problem(j_config, jax.random.key(43))
    _, _, t_starts, t_error_fn = make_problem(dataclasses.replace(config, batch_size=16), t_batch, noise)
    variables = _to64({"params": j_checkpoint["params"], "batch_stats": j_checkpoint["batch_stats"]})
    network = j_config.build_network()
    j_out = jax.jit(lambda v, s: network.apply(v, s, j_error_fn, training=False, return_trajectory=True))(
        variables, j_starts)
    with torch.no_grad():
        t_out = net(t_starts, t_error_fn, training=False, return_trajectory=True)
    for step in range(3):
        _close(t_out[step], j_out[step], 1e-10, f"step {step}")
    # rounding grows 10-1000 times a step (the trained solver diverges on
    # these starts, as in the JAX log: objective 20 to 35), so each step's
    # objective is held 100 times above the growth read (2.6e-15, 4.2e-14,
    # 5.2e-13, 7.9e-10, 1.1e-6)
    for step, tol in enumerate((1e-12, 1e-11, 1e-10, 1e-7, 1e-4)):
        objective = t_error_fn(t_out[step]).numpy()
        j_objective = np.asarray(j_error_fn(j_out[step]))
        assert np.max(np.abs(objective - j_objective) / np.abs(j_objective)) <= tol, step
