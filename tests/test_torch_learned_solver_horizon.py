"""The learned solvers' training over a horizon, against the JAX package's,
on the JAX package's own draws (float64 on the CPU, 3 views x 4 points, P
= 27, batch 8, hidden 16, two solver steps).

For each solver type (the recurrent MLP with the descent loss, the
transformer with the descent loss, the direction gate inside a
two-iteration differentiable BFGS solve) ``fit_learned_solver``'s loop
runs 8 steps (2 epochs of 4 batches) from the JAX package's initial
parameters.  The JAX side is the package's own jitted
``make_learned_solver_step``, unmodified, called with
``fit_learned_solver``'s keys (``fold_in(key, 17 + epoch * 100003 +
i)``); each key's scenes and start noise are drawn outside the step as the
step's own ``_make_problem`` draws them and fed to the port's step.  The
learning rate is constant, as in the JAX experiment (optax scales by a
float64 scalar).  Each step's metrics are held to 1e-9 relative, the
final parameters to 1e-9 relative to the largest parameter, the BatchNorm
statistics to 1e-9 and the update counts equal.

The transformer's training amplifies rounding a step
(``test_torch_learned_solver_same_draw.py`` runs JAX against itself from
perturbed parameters), the more the larger the rate, so its case runs at
1e-5, where 8 steps stay well within 1e-9; the MLP and the gate run at
1e-3.
"""

import jax
import numpy as np
import pytest
import torch

import davo_tpu.train.learned_solver as jl
from davo_tpu.camera import calibration_error as j_calibration_error
from davo_tpu_torch import models as tm
from davo_tpu_torch.train import create_learned_solver_state, make_learned_solver_step, make_problem
from davo_tpu_torch.types import CameraViewsAndPoints
from tests.test_torch_learned_solver_train import _tx
from tests.test_torch_learned_solvers import _close, _flat, configs, jax_variables
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

EPOCHS, BATCHES = 2, 4
TINY = dict(num_views=3, num_points=4, hidden_size=16, embed_dim=16, num_heads=2, num_steps=2, start_noise=0.3,
            batch_size=8, batches_per_epoch=BATCHES, epochs=EPOCHS)
CASES = {
    "mlp": dict(solver_type="mlp", loss_mode="descent", learning_rate=1e-3),
    "transformer": dict(solver_type="transformer", loss_mode="descent", learning_rate=1e-5),
    "direction": dict(solver_type="direction", loss_mode="final", learning_rate=1e-3),
}


def _draws(j_config):
    """``k -> (scenes, starts, noise)``: what ``_make_problem`` draws from a
    key (one jitted draw)."""

    @jax.jit
    def draws(k):
        batch, truth, starts, _ = jl._make_problem(j_config, k)
        return batch, starts, jax.random.normal(jax.random.split(k)[1], truth.shape, truth.dtype)

    return draws


def _port_problem(t_config, batch, noise):
    return make_problem(t_config, CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in batch)),
                        torch.tensor(np.asarray(noise)))


def eight_steps_match_jax(case):
    """The horizon of one solver type (``CASES``); each runs in a file of
    its own (this one, ``..._horizon_transformer.py``,
    ``..._horizon_direction.py``), so that xdist spreads their compiles."""
    j_config, t_config = configs(**TINY, **CASES[case])
    key = jax.random.key(61)
    network = j_config.build_network()
    draws = _draws(j_config)
    batch, starts, _ = draws(key)
    visibility = batch.visibility_mask.astype(starts.dtype)
    variables = jax_variables(network, j_config, starts, lambda p: j_calibration_error(
        p, batch.projected_points[:, None], visibility[:, None]))
    j_state = jl.LearnedSolverState.create(apply_fn=network.apply, params=variables["params"],
                                           batch_stats=variables.get("batch_stats", {}), tx=_tx(j_config))
    j_train_step = jl.make_learned_solver_step(network, j_config)

    state = create_learned_solver_state(t_config, "cpu")
    tm.load_flax_tree(state.network, variables["params"], variables.get("batch_stats"))
    train_step = make_learned_solver_step(state, t_config)

    for epoch in range(EPOCHS):
        for i in range(BATCHES):
            k = jax.random.fold_in(key, 17 + epoch * 100003 + i)
            j_state, j_metrics = j_train_step(j_state, k)
            batch, _, noise = draws(k)
            metrics = train_step(problem=_port_problem(t_config, batch, noise))
            assert set(metrics) == set(j_metrics)
            for name, value in j_metrics.items():
                _close(float(metrics[name]), float(value), 1e-9, f"epoch {epoch} step {i} {name}")
    assert state.step == int(j_state.step) == EPOCHS * BATCHES
    heads = j_config.num_heads if j_config.solver_type == "transformer" else None
    params, stats = tm.learned_solver_to_flax(state.network.state_dict(), num_heads=heads)
    scale = max(float(np.max(np.abs(v))) for v in _flat(j_state.params).values())
    for name, value in _flat(j_state.params).items():
        np.testing.assert_allclose(_flat(params)[name], np.asarray(value), rtol=1e-9, atol=1e-9 * scale,
                                   err_msg=name)
    assert _flat(stats).keys() == _flat(j_state.batch_stats).keys()
    for name, value in _flat(j_state.batch_stats).items():
        _close(_flat(stats)[name], value, 1e-9, f"batch_stats {name}")


@pytest.mark.parametrize("case", ["mlp"])
def test_eight_steps_match_jax(case):
    eight_steps_match_jax(case)
