"""One train step of each gen-1 preset (``bfgs_solver_full_gradient``,
``bfgs_solver_only_error_gradient``, ``mlp_guess``) against the JAX
package's, float64, at a small width (3 views x 5 points, hidden 16,
batch 8, the presets' own solvers), from the same JAX-initialised weights
(carried across by ``gen1_state_dict``) on the same JAX-drawn batch: the
loss and metrics to 1e-9 relative, the gradients to 1e-7 relative to the
largest, the updated parameters to 1e-9 relative to the largest and the
running statistics to 1e-9 (rounding compounds through the unrolled solve,
the analytic gradient it differentiates and their second derivatives, as
in ``test_torch_train_step.py``).
"""

import dataclasses
from typing import Any

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import davo_tpu.train.optimisation as jo
from davo_tpu import models as jm
from davo_tpu.data import SceneConfig as JSceneConfig
from davo_tpu.data import generate_batch as j_generate_batch
from davo_tpu.train import get_preset as j_get_preset
from davo_tpu.train.calibration import TrainState as JTrainState
from davo_tpu_torch import models as tm
from davo_tpu_torch.train import create_optimisation_state, get_preset, make_optimisation_train_step
from tests.test_torch_gen1 import B, M, N, _close, _flat, _to64, _torch_batch
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def _largest(tree):
    return max(float(np.max(np.abs(v))) for v in _flat(tree).values())


class _CapturingState(JTrainState):
    """The JAX train state, keeping the gradients of its last update."""

    grads: Any = flax.struct.field(pytree_node=True, default=None)

    def apply_gradients(self, *, grads, **kwargs):
        return super().apply_gradients(grads=grads, **kwargs).replace(grads=grads)


GEN1_SIZE = dict(num_views=M, num_points=N, hidden_size=16, batch_size=B)


@pytest.mark.parametrize("preset", ["bfgs_solver_full_gradient", "bfgs_solver_only_error_gradient", "mlp_guess"])
def test_gen1_train_step_matches_jax(preset, monkeypatch):
    scenes = jax.jit(lambda k: j_generate_batch(k, B, JSceneConfig(num_views=M, num_points=N, dtype=jnp.float64)))(
        jax.random.key(31))
    j_config = dataclasses.replace(j_get_preset(preset), dtype=jnp.float64, **GEN1_SIZE)
    guess = jm.PinholeMLPGuess(M, N, num_hidden=16)
    head = _to64(jax.jit(guess.init)(jax.random.key(4), scenes.projected_points, scenes.visibility_mask))
    params = {"initial_guess": head["params"]}
    batch_stats = {"initial_guess": head["batch_stats"]}
    model = j_config.build_model()
    tx = optax.chain(optax.clip_by_global_norm(j_config.clip_norm),
                     optax.adamw(j_config.learning_rate, weight_decay=j_config.weight_decay))
    state = _CapturingState.create(apply_fn=model.apply, params=params, batch_stats=batch_stats, tx=tx)
    monkeypatch.setattr(jo, "generate_batch", lambda *_: scenes)
    j_new, j_metrics = jo.make_optimisation_train_step(model, j_config)(state, jax.random.key(0))

    config = dataclasses.replace(get_preset(preset), dtype=torch.float64, **GEN1_SIZE)
    t_state = create_optimisation_state(config, "cpu")
    tm.load_flax_tree(t_state.network, params, batch_stats)
    seen = {}
    apply = t_state.apply_gradients

    def recording_apply(gradients):
        seen["grads"] = [g.clone() for g in gradients]
        apply(gradients)

    t_state.apply_gradients = recording_apply
    metrics = make_optimisation_train_step(t_state, config)(batch=_torch_batch(scenes))

    assert set(metrics) == set(j_metrics)
    for key, value in j_metrics.items():
        _close(float(metrics[key]), float(value), 1e-9, key)
    names = [name for name, _ in t_state.network.named_parameters()]
    grads = _flat(tm.gen1_to_flax(dict(zip(names, seen["grads"])))[0])
    for key, value in _flat(j_new.grads).items():
        _close(grads[key], value, 1e-7, f"gradient {key}", scale=_largest(j_new.grads))
    new_params, new_stats = tm.gen1_to_flax(t_state.network.state_dict())
    for key, value in _flat(j_new.params).items():
        _close(_flat(new_params)[key], value, 1e-9, f"parameter {key}", scale=_largest(j_new.params))
    for key, value in _flat(j_new.batch_stats).items():
        _close(_flat(new_stats)[key], value, 1e-9, f"batch_stats {key}")
    assert not np.allclose(_flat(new_stats)["/initial_guess/norm/var"], 1.0)  # the statistics moved
