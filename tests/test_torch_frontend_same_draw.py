"""``fit-frontend`` at frontend_v4's recipe, full width, the JAX package and
the port on the JAX package's own draws (slow tier, float64 on the CPU).

    python -m pytest tests/test_torch_frontend_same_draw.py --runslow -s -o addopts=

The recipe is ``artifacts/frontend_v4_metrics.jsonl``'s recorded config
(4 views x 8 points, select 8, descriptor and embedding 64, batch 16, 64
batches and 8 validation batches an epoch, 96 px, 3e-4 peak, warm-up 200,
600 epochs: the schedule spans 38,400 steps), run for EPOCHS epochs in
float64.  Both packages start from the JAX network's initial parameters
(seed 0, as ``fit_frontend``); the JAX side runs its own jitted
``make_frontend_train_step`` and ``eval_step``, unmodified, with
``fit_frontend``'s keys, and each key's windows and render draws are drawn
outside the step as the step's ``split`` draws them and fed to the port.
As in ``tests/test_torch_frontend_horizon.py``, the port's step runs at
the rate the JAX step applied (read back from its update; XLA rounds
optax's float32 schedule in the fused step), and the port's own schedule
is held to it within RATE_TOL times the peak rate at every step.

It prints one JSON line an epoch: both packages' train loss, validation
loss and ``match_inlier_rate``, the largest relative difference of a step's
metrics and of the validation metrics, the largest gap of the port's own
rate (over the peak rate), and the first step whose metrics part by more than APART; then the
final parameters' largest difference relative to the largest parameter
and the seconds.  It asserts the rates, finite figures, and each epoch's
means equal to EPOCH_TOL (relative).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import davo_tpu.train.frontend as jf
from davo_tpu.data import VOWindowConfig as JWindowConfig
from davo_tpu.data.rendering import RenderConfig as JRenderConfig
from davo_tpu_torch.data import RenderConfig, VOWindowConfig
from davo_tpu_torch.models import frontend_state_dict, frontend_state_to_flax
from davo_tpu_torch.train import FrontendExperiment, create_frontend_state, make_frontend_train_step
from davo_tpu_torch.types import CameraViewsAndPoints
from tests.test_torch_frontend_horizon import RATE_TOL, _applied_rate, _draws, _jax_state
from tests.test_torch_frontend_train import _flat

EPOCHS = 2
APART, EPOCH_TOL = 1e-9, 1e-6
SIZE = 96


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


@pytest.mark.slow
def test_frontend_v4_recipe_same_draws():
    torch.set_num_threads(8)
    j_config = jf.FrontendExperiment(epochs=600, window=JWindowConfig(dtype=jnp.float64),
                                     render=JRenderConfig(image_size=SIZE, dtype=jnp.float64))
    config = FrontendExperiment(epochs=600, window=VOWindowConfig(dtype=torch.float64),
                                render=RenderConfig(image_size=SIZE, dtype=torch.float64))
    key = jax.random.key(j_config.seed)
    network, j_state = _jax_state(j_config, key)
    state = create_frontend_state(config, "cpu")
    loaded = frontend_state_dict(j_state.params, j_state.batch_stats)
    loaded.update({k: v for k, v in state.network.state_dict().items() if k.endswith("num_batches_tracked")})
    state.network.load_state_dict(loaded)
    train_step, eval_step = make_frontend_train_step(state, config)
    j_train_step, j_eval_step = jf.make_frontend_train_step(network, j_config)
    draws = _draws(j_config)
    schedule = state.schedule

    def port(step, k):
        windows, noise = draws(k)
        return step(windows=CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in windows)), noise=noise)

    def mean(rows):
        return {name: float(np.mean([float(r[name]) for r in rows])) for name in rows[0]}

    step_key = jax.random.fold_in(key, 1)
    start, lines, first_apart = time.time(), [], None
    for epoch in range(EPOCHS):
        j_rows, t_rows, step_diff, rate_gap = [], [], 0.0, 0.0
        for i in range(j_config.batches_per_epoch):
            k = jax.random.fold_in(step_key, epoch * 100003 + i)
            before = j_state
            j_state, j_metrics = j_train_step(j_state, k)
            applied = _applied_rate(before, j_state, j_config.weight_decay)
            rate_gap = max(rate_gap, abs(schedule(state.step) - applied) / j_config.learning_rate)
            state.schedule = lambda count, applied=applied: applied
            metrics = port(train_step, k)
            diff = max(_rel(metrics[n], v) for n, v in j_metrics.items())
            step_diff = max(step_diff, diff)
            if first_apart is None and diff > APART:
                first_apart = dict(epoch=epoch, step=i, relative_difference=diff)
            j_rows.append(j_metrics)
            t_rows.append(metrics)
        j_val, t_val = [], []
        for j in range(j_config.val_batches):
            k = jax.random.fold_in(step_key, 777000 + epoch * 1009 + j)
            j_val.append(j_eval_step(j_state, k))
            t_val.append(port(eval_step, k))
        jt, tt, jv, tv = mean(j_rows), mean(t_rows), mean(j_val), mean(t_val)
        line = dict(
            epoch=epoch, jax=dict(loss=jt["loss"], val_loss=jv["loss"], match_inlier_rate=jv["match_inlier_rate"]),
            port=dict(loss=tt["loss"], val_loss=tv["loss"], match_inlier_rate=tv["match_inlier_rate"]),
            max_step_metric_rel_diff=step_diff,
            max_val_metric_rel_diff=max(_rel(t[n], j[n]) for t, j in zip(t_val, j_val) for n in j),
            max_port_rate_gap=rate_gap, first_step_apart=first_apart, seconds=time.time() - start,
        )
        lines.append(line)
        print(json.dumps(line), flush=True)
    params, _ = frontend_state_to_flax(state.network.state_dict())
    a, b = _flat(params), _flat(j_state.params)
    scale = max(float(np.abs(v).max()) for v in b.values())
    print(json.dumps({"final_params_max_diff_rel_to_largest": max(float(np.abs(a[n] - b[n]).max()) for n in b) / scale,
                      "steps": state.step, "seconds": time.time() - start}), flush=True)
    for line in lines:
        assert line["max_port_rate_gap"] <= RATE_TOL
        for name in ("loss", "val_loss", "match_inlier_rate"):
            assert np.isfinite([line["jax"][name], line["port"][name]]).all()
            np.testing.assert_allclose(line["port"][name], line["jax"][name], rtol=EPOCH_TOL, err_msg=name)
