"""The learned solvers' training and evaluation against the JAX package's,
float64, on JAX-drawn scenes and starts (3 views x 4 points, P = 27).

* One train step of the recurrent MLP solver (hidden 16, two steps) under
  each loss mode ("final", "descent") and of the direction gate (hidden
  16, inside a two-iteration differentiable BFGS solve with 16 probes),
  batch 8, from the JAX package's initial weights: the loss and metrics to
  1e-9 relative, the gradients to 1e-7 relative to the largest, the
  updated parameters to 1e-9 relative to the largest, the BatchNorm
  statistics to 1e-9 (moved twice for the MLP, never for the gate, whose
  solve runs it with training=False) and the AdamW step count.

``compare_with_bfgs`` is held in ``test_torch_learned_solver_compare.py``.
"""

from typing import Any

import flax
import jax
import numpy as np
import optax
import pytest

import davo_tpu.train.learned_solver as jl
from davo_tpu_torch import models as tm
from davo_tpu_torch.train import create_learned_solver_state, make_learned_solver_step, make_problem
from tests.test_torch_learned_solvers import _close, _flat, configs, jax_problem, jax_variables
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

TINY = dict(num_views=3, num_points=4, hidden_size=16, num_steps=2, start_noise=0.3, batch_size=8,
            learning_rate=1e-3)
CASES = {
    "mlp_final": dict(solver_type="mlp", loss_mode="final"),
    "mlp_descent": dict(solver_type="mlp", loss_mode="descent"),
    "direction": dict(solver_type="direction"),
}


class _CapturingState(jl.LearnedSolverState):
    """The JAX train state, keeping the gradients of its last update."""

    grads: Any = flax.struct.field(pytree_node=True, default=None)

    def apply_gradients(self, *, grads, **kwargs):
        return super().apply_gradients(grads=grads, **kwargs).replace(grads=grads)


def _tx(j_config):
    """The JAX experiment's optimiser (``create_learned_solver_state``'s)."""
    return optax.chain(optax.clip_by_global_norm(j_config.clip_norm),
                       optax.adamw(j_config.learning_rate, weight_decay=j_config.weight_decay))


def _largest(tree):
    return max(float(np.max(np.abs(v))) for v in _flat(tree).values())


@pytest.fixture(scope="module")
def train_problem():
    """The train steps' problem (the same for every case)."""
    return jax_problem(configs(**TINY)[0], jax.random.key(51))


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case, monkeypatch, train_problem):
    j_config, t_config = configs(**TINY, **CASES[case])
    problem, t_batch, noise = train_problem
    network = j_config.build_network()
    variables = jax_variables(network, j_config, problem[2], problem[3])
    state = _CapturingState.create(apply_fn=network.apply, params=variables["params"],
                                   batch_stats=variables.get("batch_stats", {}), tx=_tx(j_config))
    monkeypatch.setattr(jl, "_make_problem", lambda *_: problem)
    j_new, j_metrics = jl.make_learned_solver_step(network, j_config)(state, jax.random.key(1))

    t_state = create_learned_solver_state(t_config, "cpu")
    tm.load_flax_tree(t_state.network, variables["params"], variables.get("batch_stats"))
    seen = {}
    apply = t_state.apply_gradients

    def recording_apply(gradients):
        seen["grads"] = [g.clone() for g in gradients]
        apply(gradients)

    t_state.apply_gradients = recording_apply
    metrics = make_learned_solver_step(t_state, t_config)(problem=make_problem(t_config, t_batch, noise))

    assert set(metrics) == set(j_metrics)
    for key, value in j_metrics.items():
        _close(float(metrics[key]), float(value), 1e-9, key)
    names = [name for name, _ in t_state.network.named_parameters()]
    grads = _flat(tm.learned_solver_to_flax(dict(zip(names, seen["grads"])))[0])
    scale = _largest(j_new.grads)
    for key, value in _flat(j_new.grads).items():
        np.testing.assert_allclose(grads[key], np.asarray(value), rtol=1e-7, atol=1e-7 * scale, err_msg=key)
    new_params, new_stats = tm.learned_solver_to_flax(t_state.network.state_dict())
    scale = _largest(j_new.params)
    for key, value in _flat(j_new.params).items():
        np.testing.assert_allclose(_flat(new_params)[key], np.asarray(value), rtol=1e-9, atol=1e-9 * scale,
                                   err_msg=key)
    assert _flat(new_stats).keys() == _flat(j_new.batch_stats).keys()
    for key, value in _flat(j_new.batch_stats).items():
        _close(_flat(new_stats)[key], value, 1e-9, f"batch_stats {key}")
    moved = any(not np.array_equal(_flat(new_stats)[k], np.asarray(v))
                for k, v in _flat(variables.get("batch_stats", {})).items())
    assert moved == (t_config.solver_type == "mlp")
    assert t_state.step == int(j_new.step) == 1
