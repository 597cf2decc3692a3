"""The front end's training over a horizon, against the JAX package's, on
the JAX package's own draws (float64 on the CPU, a small size: 32 px
images, descriptor and embedding width 8, batches of 2 windows of 4 views
x 8 points).

``fit_frontend``'s loop runs 16 steps (4 epochs of 4 batches) of a
schedule of 32 (8 epochs: warm-up 6 steps, then the cosine decay), so the
run climbs the warm-up and goes into the decay of a schedule longer than
itself, as a cut comparison with a logged run does.  The JAX side is the
package's own jitted ``make_frontend_train_step`` and ``eval_step``,
unmodified, called with ``fit_frontend``'s keys (``fold_in(step_key,
epoch * 100003 + i)``, validation ``fold_in(step_key, 777000 + epoch *
1009 + j)``); each key's windows and render draws are drawn outside the
step as the step's own ``split`` draws them and fed to the port's steps,
which start from the JAX package's initial parameters.

optax evaluates its schedule at an int32 count, so the JAX package's rate
is float32 arithmetic (its warm-up ``peak - peak * (1 - count / warmup)``
cancels: an error of a float32 ulp of the peak), and XLA fuses it into
the jitted step, where it rounds otherwise than optax's own eager call.
So the rate the JAX step applied is read
back from its update (AdamW's direction from its moments, by least
squares), the port's schedule is held to it at every step within
RATE_TOL times the peak rate (4 float32 ulps of the peak), and the port's
step then runs at that rate: each step's metrics are held to 1e-9
relative, each epoch's validation metrics to 1e-9, and the final
parameters to 1e-9 relative to the largest parameter, the BatchNorm
statistics to 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

import davo_tpu.train.frontend as jf
from davo_tpu.data import generate_vo_window_batch as j_generate_vo_window_batch
from davo_tpu_torch.models import frontend_state_dict, frontend_state_to_flax
from davo_tpu_torch.train import create_frontend_state, make_frontend_train_step
from davo_tpu_torch.types import CameraViewsAndPoints
from tests.test_torch_frontend_train import _close_trees, _experiments, _to64
from tests.test_torch_rendering import _jax_render_draws
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

EPOCHS, BATCHES, SCHEDULE_EPOCHS = 4, 4, 8
RATE_TOL = 2.4e-7  # times the peak rate: 4 float32 ulps of it
FIELDS = dict(learning_rate=3e-3, weight_decay=1e-2, clip_norm=0.5, warmup_steps=6, epochs=SCHEDULE_EPOCHS,
              batches_per_epoch=BATCHES, val_batches=1)


def _draws(j_config):
    """The windows and render draws ``make_frontend_train_step``'s steps
    make from a key, for the port."""
    window_config = dataclasses.replace(j_config.window, num_views=j_config.num_views,
                                        num_points=j_config.num_points)

    @jax.jit
    def windows_of(key):
        k_data, _ = jax.random.split(key)
        return j_generate_vo_window_batch(k_data, j_config.batch_size, window_config)

    def draws(key):
        windows = CameraViewsAndPoints(*(np.asarray(x) for x in windows_of(key)))
        noise = _jax_render_draws(jax.random.split(key)[1], j_config.batch_size, j_config.num_views,
                                  j_config.num_points, j_config.render)
        return CameraViewsAndPoints(*(jnp.asarray(x) for x in windows)), noise

    return draws


def _jax_state(j_config, key):
    """The JAX package's train state as ``create_frontend_state`` builds
    it (its network's initial parameters, the optax chain), the init
    jitted."""
    network = j_config.build_network()
    images = jnp.zeros((2, j_config.num_views, j_config.render.image_size, j_config.render.image_size,
                        j_config.render.channels), j_config.render.dtype)
    variables = jax.jit(lambda k, x: network.init({"params": k}, x, training=False))(jax.random.split(key)[0], images)
    total = max(j_config.epochs * j_config.batches_per_epoch, 2)
    warmup = min(j_config.warmup_steps, total // 2)
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=j_config.learning_rate, warmup_steps=warmup, decay_steps=max(total, warmup + 1),
        end_value=0.1 * j_config.learning_rate,
    )
    tx = optax.chain(optax.clip_by_global_norm(j_config.clip_norm),
                     optax.adamw(schedule, weight_decay=j_config.weight_decay))
    return network, jf.FrontendTrainState.create(apply_fn=network.apply, params=_to64(variables["params"]),
                                                 batch_stats=_to64(variables["batch_stats"]), tx=tx)


def _applied_rate(before, after, weight_decay):
    """The rate a JAX step applied: its parameter change against optax's
    AdamW direction ``mu_hat / (sqrt(nu_hat) + eps) + weight_decay * p``
    from the updated moments (least squares over every parameter)."""
    adam = after.opt_state[1][0]
    count = int(adam.count)
    leaves = zip(*(jax.tree_util.tree_leaves(t) for t in (before.params, after.params, adam.mu, adam.nu)))
    num = den = 0.0
    for p0, p1, mu, nu in leaves:
        p0, p1, mu, nu = (np.asarray(x) for x in (p0, p1, mu, nu))
        direction = mu / (1 - 0.9**count) / (np.sqrt(nu / (1 - 0.999**count)) + 1e-8) + weight_decay * p0
        num += float(np.sum((p0 - p1) * direction))
        den += float(np.sum(direction * direction))
    return num / den


def _close(actual, expected, tol, name):
    np.testing.assert_allclose(float(actual), float(expected), rtol=tol, atol=tol * 1e-3, err_msg=name)


def test_sixteen_steps_into_the_decay_match_jax():
    import torch

    j_config, config = _experiments(**FIELDS)
    key = jax.random.key(7)
    network, j_state = _jax_state(j_config, key)
    state = create_frontend_state(config, "cpu")
    loaded = frontend_state_dict(j_state.params, j_state.batch_stats)
    loaded.update({k: v for k, v in state.network.state_dict().items() if k.endswith("num_batches_tracked")})
    state.network.load_state_dict(loaded)
    train_step, eval_step = make_frontend_train_step(state, config)
    j_train_step, j_eval_step = jf.make_frontend_train_step(network, j_config)
    draws = _draws(j_config)

    def port(step, key):
        windows, noise = draws(key)
        return step(windows=CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in windows)), noise=noise)

    step_key = jax.random.fold_in(key, 1)
    schedule, rates = state.schedule, []
    for epoch in range(EPOCHS):
        for i in range(BATCHES):
            k = jax.random.fold_in(step_key, epoch * 100003 + i)
            before = j_state
            j_state, j_metrics = j_train_step(j_state, k)
            applied = _applied_rate(before, j_state, FIELDS["weight_decay"])
            rates.append(schedule(state.step))
            np.testing.assert_allclose(rates[-1], applied, rtol=0, atol=RATE_TOL * FIELDS["learning_rate"],
                                       err_msg=f"step {state.step}")
            state.schedule = lambda count, applied=applied: applied
            metrics = port(train_step, k)
            for name, value in j_metrics.items():
                _close(metrics[name], value, 1e-9, f"epoch {epoch} step {i} {name}")
        k = jax.random.fold_in(step_key, 777000 + epoch * 1009)
        j_val = j_eval_step(j_state, k)
        val = port(eval_step, k)
        assert set(val) == set(j_val)
        for name, value in j_val.items():
            _close(val[name], value, 1e-9, f"epoch {epoch} validation {name}")
    # the run climbed the warm-up and went into the decay, short of its end
    peak = FIELDS["learning_rate"]
    assert np.isclose(rates[FIELDS["warmup_steps"]], peak, rtol=1e-12) and 0.1 * peak < rates[-1] < 0.999 * peak
    assert state.step == int(j_state.step) == EPOCHS * BATCHES
    params, stats = frontend_state_to_flax(state.network.state_dict())
    _close_trees(params, j_state.params, 1e-9, relative_to_largest=True)
    _close_trees(stats, j_state.batch_stats, 1e-9)
