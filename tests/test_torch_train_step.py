"""One training step of the port against the JAX package's, float64.

The JAX step is its ``_loss_and_metrics`` under ``jax.grad`` followed by
``TrainState.apply_gradients`` with the optimiser chain of
``create_train_state`` (``optax.chain(clip_by_global_norm, adamw)``); the
port's is ``make_train_step`` on the same weights (carried across by
``convert.py``) and the same injected batch of 8 scenes.  Three setups:

* the MLP head (hidden 24) through a 3-iteration unrolled solve with
  drop-path 0.3, the JAX keep-masks recomputed from the key its solve
  receives and injected;
* the transformer head (2 layers, width 32) with ``training_iterations=0``
  (the curriculum recipe: the guess itself is trained);
* the 3-token transformer head, winner-take-all on the raw tokens.

Compared: the loss and every metric to 1e-9 relative; the gradients
before clipping to 1e-7 relative to the largest gradient; the parameters
after the update to 1e-9 relative to the largest parameter, and the
BatchNorm running statistics to 1e-9 relative (rounding compounds
through the solve's second derivatives; gradients that are rounding
noise about zero, as the attention's key biases', take Adam's first
update to a noise of about lr · 1e-8).  Then the
pieces alone: the schedule against ``optax.warmup_cosine_decay_schedule``
step by step (1e-12), the clipping against ``optax.clip_by_global_norm``
(1e-12), three updates of the whole chain against optax's (1e-7 relative
to the largest parameter: inside the chain optax reads its schedule at an
int32 count, which rounds the rate to float32 even under x64, a relative
6e-8; the port keeps the rate in double), and the flax-style initial
weights' statistics against flax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import davo_tpu.models.calibration_network as j_network_module
from davo_tpu.data import SceneConfig as JSceneConfig
from davo_tpu.data import generate_batch as j_generate_batch
from davo_tpu.models.calibration_network import CalibrationMLPHead as JMLPHead
from davo_tpu.models.calibration_network import CalibrationTransformerHead as JTransformerHead
from davo_tpu.solve import BFGSConfig as JBFGSConfig
from davo_tpu.train import calibration as jc
from davo_tpu_torch.models import CalibrationNetwork, load_flax_weights, state_dict_to_flax
from davo_tpu_torch.solve import BFGSConfig
from davo_tpu_torch.train import calibration as tc
from davo_tpu_torch.types import CameraViewsAndPoints
from tests.test_torch_eval_entry import _injected
from tests.test_torch_train_solve import _jax_keep_masks
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

M, N, B = 4, 8, 8
P = 3 + 3 * N + 6 * (M - 1)
TRANSFORMER = dict(head="transformer", hidden_size=32, transformer_layers=2, transformer_heads=4)
SETUPS = {
    "mlp_unrolled": dict(
        setting=dict(head="mlp", hidden_size=24),
        solver=dict(error_threshold=1e-7, training_error_threshold=1e-3, iterations=10, training_iterations=3,
                    line_search_iterations=20, drop_path_p=0.3),
    ),
    "transformer_guess_only": dict(
        setting=TRANSFORMER,
        solver=dict(error_threshold=1e-7, iterations=10, training_iterations=0, line_search_iterations=20,
                    drop_path_p=0.0),
    ),
    "transformer_tokens": dict(
        setting=dict(TRANSFORMER, guess_tokens=3),
        solver=dict(error_threshold=1e-7, iterations=10, training_iterations=0, line_search_iterations=20,
                    drop_path_p=0.0),
    ),
}
OPTIMISER = dict(schedule="constant", learning_rate=1e-3, weight_decay=0.01, clip_norm=1.0, structure_weight=1.0)


@pytest.fixture(scope="module")
def scenes():
    return jax.jit(lambda k: j_generate_batch(k, B, JSceneConfig(dtype=jnp.float64)))(jax.random.key(31))


def _to64(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _head_variables(setting, scenes):
    """The network's variables from its head's own init (the network's
    init would run the eval solve)."""
    if setting["head"] == "mlp":
        head = JMLPHead(num_outputs=P, hidden_size=setting["hidden_size"])
        variables = jax.jit(head.init)(jax.random.key(4), scenes.projected_points.reshape(B, -1))
        stats = {"initial_estimator": variables["batch_stats"]}
    else:
        head = JTransformerHead(num_outputs=P, num_views=M, num_points=N, embed_dim=32, num_layers=2, num_heads=4,
                                num_tokens=setting.get("guess_tokens", 1))
        variables = jax.jit(head.init)(jax.random.key(4), scenes.projected_points, scenes.visibility_mask)
        stats = {}
    return _to64({"initial_estimator": variables["params"]}), _to64(stats)


def _named(tree_grads, network):
    return dict(zip([name for name, _ in network.named_parameters()], tree_grads))


def _close(actual, expected, tol, name, scale=None):
    """Within ``tol`` relative, or ``tol`` times ``scale`` (default: the
    largest entry of ``expected``) absolute."""
    actual, expected = np.asarray(actual), np.asarray(expected)
    if scale is None:
        scale = float(np.max(np.abs(expected)))
    np.testing.assert_allclose(actual, expected, rtol=tol, atol=tol * max(scale, 1e-300), err_msg=name)


def _largest(tree):
    return max(float(np.max(np.abs(v))) for v in _flat(tree).values())


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("name", sorted(SETUPS))
def test_train_step_matches_jax(scenes, monkeypatch, name):
    setup = SETUPS[name]
    fields = dict(num_views=M, num_points=N, batch_size=B, **OPTIMISER, **setup["setting"])
    j_config = _injected(jc.CalibrationExperiment, lambda *_: scenes, dtype=jnp.float64,
                         solver=JBFGSConfig(**setup["solver"]), **fields)
    params, batch_stats = _head_variables(setup["setting"], scenes)
    network = j_config.build_network()
    tx = optax.chain(optax.clip_by_global_norm(j_config.clip_norm),
                     optax.adamw(j_config.learning_rate, weight_decay=j_config.weight_decay))
    state = jc.TrainState.create(apply_fn=network.apply, params=params, batch_stats=batch_stats, tx=tx)

    captured = {}
    solve = j_network_module.bfgs_solve

    def capturing_solve(*args, **kwargs):
        captured["key"] = kwargs.get("key")
        return solve(*args, **kwargs)

    monkeypatch.setattr(j_network_module, "bfgs_solve", capturing_solve)
    drop_key = jax.random.key(17)

    def loss_fn(p):
        loss, aux = jc._loss_and_metrics(network, p, state.batch_stats, scenes, training=True, drop_key=drop_key,
                                         structure_weight=j_config.structure_weight)
        # the key the solve draws its keep-masks from, out of the trace
        key = captured.get("key")
        return loss, (aux, jnp.zeros(2, jnp.uint32) if key is None else jax.random.key_data(key))

    j_grads, ((j_metrics, j_stats), key_data) = jax.jit(jax.grad(loss_fn, has_aux=True))(state.params)
    j_new = state.apply_gradients(grads=j_grads, batch_stats=j_stats)
    keep_masks = None
    if setup["solver"]["drop_path_p"] > 0:
        keep_masks = torch.tensor(_jax_keep_masks(jax.random.wrap_key_data(key_data),
                                                  setup["solver"]["training_iterations"],
                                                  setup["solver"]["drop_path_p"], batch=B))
        assert 0 < float(keep_masks.double().mean()) < 1

    batch = CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in scenes))
    config = _injected(tc.CalibrationExperiment, lambda *_: batch, dtype=torch.float64,
                       solver=BFGSConfig(**setup["solver"]), **fields)
    t_state = tc.create_train_state(config, "cpu")
    load_flax_weights(t_state.network, params, batch_stats)
    seen = {}
    apply = t_state.apply_gradients

    def recording_apply(gradients):
        seen["grads"] = [g.clone() for g in gradients]
        apply(gradients)

    t_state.apply_gradients = recording_apply
    metrics = tc.make_train_step(t_state, config)(torch.Generator().manual_seed(0), keep_masks=keep_masks)

    assert set(metrics) == set(j_metrics)
    for key, value in j_metrics.items():
        _close(float(metrics[key]), float(value), 1e-9, key)
    heads = 4 if setup["setting"]["head"] == "transformer" else None
    grads = _flat(state_dict_to_flax(_named(seen["grads"], t_state.network), num_heads=heads)[0])
    # relative to the largest gradient: some are rounding noise about 0
    # (the attention's key biases shift every score of a query alike)
    for key, value in _flat(j_grads).items():
        _close(grads[key], value, 1e-7, f"gradient {key}", scale=_largest(j_grads))
    new_params, new_stats = state_dict_to_flax(t_state.network.state_dict(), num_heads=heads)
    for key, value in _flat(j_new.params).items():
        _close(_flat(new_params)[key], value, 1e-9, f"parameter {key}", scale=_largest(j_new.params))
    assert _flat(new_stats).keys() == _flat(j_new.batch_stats).keys()
    for key, value in _flat(j_new.batch_stats).items():
        _close(_flat(new_stats)[key], value, 1e-9, f"batch_stats {key}")
    assert t_state.step == int(j_new.step) == 1
    if setup["setting"]["head"] == "mlp":  # the running statistics moved
        assert not np.allclose(_flat(new_stats)["/initial_estimator/norm_1/var"], 1.0)


def _optax_schedule(config):
    """The JAX package's schedule, as ``create_train_state`` builds it."""
    total = max(config.epochs * config.batches_per_epoch, 2)
    warmup = min(config.warmup_steps, total // 2)
    return optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=config.learning_rate, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=0.1 * config.learning_rate,
    )


@pytest.mark.parametrize(
    "fields",
    [dict(epochs=3, batches_per_epoch=10, warmup_steps=5), dict(epochs=2, batches_per_epoch=8),
     dict(epochs=1, batches_per_epoch=1, warmup_steps=0)],
    ids=["warmup_5", "warmup_capped_at_half", "two_steps_no_warmup"],
)
def test_schedule_matches_optax(fields):
    config = tc.CalibrationExperiment(learning_rate=3e-4, **fields)
    steps = config.epochs * config.batches_per_epoch
    schedule = tc.learning_rate_schedule(config.learning_rate, steps, config.warmup_steps, config.schedule)
    want = _optax_schedule(config)
    total = max(steps, 2)
    values = [schedule(k) for k in range(total + 5)]
    np.testing.assert_allclose(values, [float(want(k)) for k in range(total + 5)], rtol=1e-12, atol=1e-18)
    if config.warmup_steps:
        assert values[0] == 0.0  # the first update's rate under the warm-up
    constant = tc.learning_rate_schedule(config.learning_rate, steps, config.warmup_steps, "constant")
    assert constant(0) == constant(1000) == 3e-4


@pytest.mark.parametrize("scale", [0.01, 1.0, 50.0])
def test_clipping_matches_optax(scale):
    rng = np.random.default_rng(1)
    grads = [scale * rng.normal(size=shape) for shape in [(3, 4), (5,), (2, 2, 2)]]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.tensor(g) for g in grads]
    tc.clip_by_global_norm_(got, 1.0)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-15)


def test_three_updates_match_optax_chain():
    """clip + AdamW + the warm-up schedule over three updates (the first
    at rate 0) on the MLP network's parameters, flax-named on the optax
    side, with weight decay on every parameter."""
    config = tc.CalibrationExperiment(num_views=M, num_points=N, hidden_size=16, epochs=1, batches_per_epoch=8,
                                      warmup_steps=2, learning_rate=1e-2, dtype=torch.float64)
    state = tc.create_train_state(config, "cpu")
    params, _ = state_dict_to_flax(state.network.state_dict())
    tx = optax.chain(optax.clip_by_global_norm(config.clip_norm),
                     optax.adamw(_optax_schedule(config), weight_decay=config.weight_decay))
    opt_state = tx.init(params)
    rng = np.random.default_rng(2)
    names = [name for name, _ in state.network.named_parameters()]
    for _ in range(3):
        grads = [torch.tensor(rng.normal(size=tuple(p.shape))) for p in state.network.parameters()]
        # copies: the port clips its gradients in place
        flax_grads = state_dict_to_flax({name: g.clone() for name, g in zip(names, grads)})[0]
        updates, opt_state = tx.update(flax_grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        state.apply_gradients(grads)
    got = _flat(state_dict_to_flax(state.network.state_dict())[0])
    for key, value in _flat(params).items():
        _close(got[key], value, 1e-7, key, scale=_largest(params))
    assert state.step == 3


def _lecun_std(key, shape):
    """The std flax's initialiser gives a leaf: lecun_normal's
    sqrt(1 / fan_in) for kernels (the attention's per-head kernels have
    fan_in d, its output kernel heads * head_dim), 0.02 for embeddings."""
    if not key.endswith("kernel"):
        return 0.02
    fan_in = shape[0] * shape[1] if key.endswith("out/kernel") else shape[0]
    return (1.0 / fan_in) ** 0.5


def test_flax_style_initial_weights():
    """Dense kernels: lecun_normal (std sqrt(1/fan_in), no draw beyond two
    of the untruncated normal's std) and zero biases; embeddings std 0.02;
    norms at one and zero; BatchNorm statistics 0 and 1.  Every leaf's
    std, the port's and flax's own initialiser's on the same shapes, within
    five standard errors (sqrt(1 / 2n) relative) of the intended one."""
    net = CalibrationNetwork(M, N, hidden_size=256, head="transformer", transformer_layers=1, transformer_heads=4,
                             guess_tokens=8, device="cpu", dtype=torch.float64,
                             generator=torch.Generator().manual_seed(0))
    j_head = JTransformerHead(num_outputs=P, num_views=M, num_points=N, embed_dim=256, num_layers=1, num_heads=4,
                              num_tokens=8)
    j_params = _flat(jax.jit(j_head.init)(jax.random.key(0), jnp.zeros((1, M, N, 2)), jnp.ones((1, M, N)))["params"])
    params = _flat(state_dict_to_flax(net.state_dict(), num_heads=4)[0]["initial_estimator"])
    assert params.keys() == j_params.keys()
    for key, value in params.items():
        assert value.shape == j_params[key].shape, key
        if key.endswith("bias"):
            assert not value.any(), key
        elif key.endswith("scale"):
            assert (value == 1.0).all(), key
        else:
            std = _lecun_std(key, value.shape)
            for label, leaf in (("port", value), ("flax", j_params[key])):
                np.testing.assert_allclose(leaf.std(), std, rtol=5.0 / (2.0 * leaf.size) ** 0.5, err_msg=f"{label} {key}")
            if key.endswith("kernel"):
                assert np.abs(value).max() <= 2.0 * std / 0.87962566103423978, key
    mlp = CalibrationNetwork(M, N, hidden_size=64, device="cpu", generator=torch.Generator().manual_seed(0))
    assert torch.equal(mlp.initial_estimator.norm_1.running_var, torch.ones(64))
    assert torch.equal(mlp.initial_estimator.norm_1.running_mean, torch.zeros(64))
