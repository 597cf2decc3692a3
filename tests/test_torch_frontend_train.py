"""The front end's training against the JAX package's, float64 on the CPU,
at a small size (32 px images, descriptor and embedding width 8, windows
of 4 views x 8 points drawn and rendered by the JAX package).

* The 2-D flax BatchNorm: training output and updated running statistics
  against ``nn.BatchNorm`` under ``mutable=["batch_stats"]`` (1e-12), and
  eval mode against the running-average normalisation (1e-12).
* The training forward (dropout 0.1, the JAX matcher's ``bernoulli``
  draw captured and injected) and the ``frontend_loss`` gradient against
  ``jax.grad``: outputs and metrics to 1e-10, gradients to 1e-8 relative
  to the largest, running statistics to 1e-10.
* Two steps of ``make_frontend_train_step`` against the JAX package's own
  train step (its optax chain: clipping that acts, AdamW with weight
  decay, the warm-up/cosine schedule), on the same injected windows and
  render noise: metrics to 1e-10, parameters after each step to 1e-9
  relative to the largest parameter (optax reads its schedule at an int32
  count and rounds the rate to float32, a relative 6e-8 of an update of
  at most lr), running statistics to 1e-10; the eval step's metrics on
  the trained weights to 1e-8 (those parameter differences, through the
  forward).
* A one-epoch ``fit_frontend`` on the CPU: finite per-epoch means under
  the JAX package's names, and an update count of ``batches_per_epoch``.
* The schedule against ``optax.warmup_cosine_decay_schedule`` (1e-12).
* The flax-style initial weights of the convolutions: zero biases, unit
  norms, and kernel standard deviations of ``1 / sqrt(kh kw cin)``.
* ``python -m davo_tpu_torch.cli fit-frontend --platform cpu`` writes a
  checkpoint that the JAX package's ``restore_checkpoint`` and the port's
  ``load_frontend`` both read, and their eval forwards agree (1e-5, the
  CLI trains in float32).
"""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import davo_tpu.train.frontend as jf
from davo_tpu.data import VOWindowConfig as JWindowConfig
from davo_tpu.data import generate_vo_window_batch as j_generate_vo_window_batch
from davo_tpu.data.rendering import RenderConfig as JRenderConfig
from davo_tpu.models.vo_frontend import VOFrontend as JVOFrontend
from davo_tpu.train import restore_checkpoint as j_restore_checkpoint
from davo_tpu_torch import cli
from davo_tpu_torch.data import RenderConfig, VOWindowConfig
from davo_tpu_torch.models import frontend_state_dict, frontend_state_to_flax, load_frontend
from davo_tpu_torch.models.detector import _FlaxBatchNorm2d
from davo_tpu_torch.train import (
    FrontendExperiment,
    create_frontend_state,
    fit_frontend,
    frontend_loss,
    make_frontend_train_step,
)
from davo_tpu_torch.types import CameraViewsAndPoints
from tests.test_torch_rendering import _jax_render_draws
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

B, SIZE, WIDTH = 2, 32, 8
NETWORK = dict(num_select=8, descriptor_channels=WIDTH, embedding_size=WIDTH)


def _experiments(**fields):
    j_config = jf.FrontendExperiment(
        window=JWindowConfig(dtype=jnp.float64), render=JRenderConfig(image_size=SIZE, dtype=jnp.float64),
        batch_size=B, **NETWORK, **fields,
    )
    config = FrontendExperiment(
        window=VOWindowConfig(dtype=torch.float64), render=RenderConfig(image_size=SIZE, dtype=torch.float64),
        batch_size=B, **NETWORK, **fields,
    )
    return j_config, config


def _windows(key, j_config):
    windows = j_generate_vo_window_batch(key, B, dataclasses.replace(j_config.window, num_views=4, num_points=8))
    return windows, CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in windows))


def _to64(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _port_frontend(config, params, batch_stats, **options):
    frontend = config.build_network("cpu", **options)
    state = frontend_state_dict(params, batch_stats)
    state.update({k: v for k, v in frontend.state_dict().items() if k.endswith("num_batches_tracked")})
    frontend.load_state_dict(state)
    return frontend


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


def _close_trees(actual, expected, tol, relative_to_largest=False):
    actual, expected = _flat(actual), _flat(expected)
    assert set(actual) == set(expected)
    scale = max(float(np.max(np.abs(v))) for v in expected.values()) if relative_to_largest else 1.0
    for name, value in expected.items():
        np.testing.assert_allclose(actual[name], value, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("training", [True, False], ids=["training", "eval"])
def test_flax_batch_norm_2d_matches_flax(training):
    rng = np.random.default_rng(0)
    x = rng.normal(loc=0.5, scale=2.0, size=(6, 5, 7, 3))  # NHWC
    scale, bias = rng.uniform(0.5, 1.5, 3), rng.normal(size=3)
    mean, var = rng.normal(size=3), rng.uniform(0.5, 2.0, 3)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    norm = fnn.BatchNorm(use_running_average=not training)
    want, mutated = norm.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    module = _FlaxBatchNorm2d(3).double()
    with torch.no_grad():
        module.weight.copy_(torch.tensor(scale))
        module.bias.copy_(torch.tensor(bias))
        module.running_mean.copy_(torch.tensor(mean))
        module.running_var.copy_(torch.tensor(var))
    got = module(torch.tensor(x).permute(0, 3, 1, 2), training).permute(0, 2, 3, 1)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=1e-12, atol=1e-12)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(module.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(module.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-12, atol=1e-12)
    if not training:
        np.testing.assert_array_equal(module.running_mean.numpy(), mean)
        # eval is torch's own inference normalisation, bit for bit
        plain = torch.nn.BatchNorm2d(3, eps=1e-5).double().eval()
        plain.load_state_dict(module.state_dict())
        np.testing.assert_array_equal(to_numpy(plain(torch.tensor(x).permute(0, 3, 1, 2))),
                                      to_numpy(module(torch.tensor(x).permute(0, 3, 1, 2))))


def test_training_forward_and_gradient_match_jax_grad(monkeypatch):
    j_config, config = _experiments()
    key = jax.random.key(3)
    windows, t_windows = _windows(key, j_config)
    images = jf.render_scene_batch(jax.random.fold_in(key, 1), windows, j_config.render)
    j_net = JVOFrontend(dropout=0.1, **NETWORK)
    variables = _to64(j_net.init({"params": jax.random.key(4)}, images, training=False))
    params, batch_stats = variables["params"], variables["batch_stats"]

    draws = []
    bernoulli = jax.random.bernoulli

    def capturing(k, p, shape):
        mask = bernoulli(k, p, shape)
        draws.append(np.asarray(mask))
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", capturing)

    def loss_fn(p):
        out, mutated = j_net.apply({"params": p, "batch_stats": batch_stats}, images, training=True,
                                   mutable=["batch_stats"], rngs={"dropout": jax.random.key(9)})
        loss, metrics = jf.frontend_loss(out, windows, j_config)
        return loss, (metrics, mutated["batch_stats"], out)

    j_grads, (j_metrics, j_stats, j_out) = jax.grad(loss_fn, has_aux=True)(params)
    assert len(draws) == 1 and draws[0].shape == (B * 3, 16, 16) and not draws[0].all()

    frontend = _port_frontend(config, params, batch_stats, dropout=0.1)
    out = frontend(torch.tensor(np.asarray(images)), training=True, dropout_mask=torch.tensor(draws[0]))
    loss, metrics = frontend_loss(out, t_windows, config)
    metrics = {name: value.detach() for name, value in metrics.items()}
    names = [name for name, _ in frontend.named_parameters()]
    grads = torch.autograd.grad(loss, list(frontend.parameters()))
    for name in ("points", "scores", "matched", "matches"):
        np.testing.assert_allclose(to_numpy(getattr(out, name)), np.asarray(getattr(j_out, name)), rtol=1e-10,
                                   atol=1e-10, err_msg=name)
    for name, value in j_metrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), rtol=1e-10, atol=1e-12, err_msg=name)
    grad_tree, _ = frontend_state_to_flax(dict(zip(names, grads)))
    _close_trees(grad_tree, j_grads, 1e-8, relative_to_largest=True)
    _, stats = frontend_state_to_flax(frontend.state_dict())
    _close_trees(stats, j_stats, 1e-10)


def test_two_train_steps_match_jax(monkeypatch):
    fields = dict(learning_rate=1e-2, weight_decay=1e-2, clip_norm=0.5, warmup_steps=1, epochs=1,
                  batches_per_epoch=4)
    j_config, config = _experiments(**fields)
    network, j_state = jf.create_frontend_state(j_config, jax.random.key(5))
    j_state = jf.FrontendTrainState.create(
        apply_fn=network.apply, params=_to64(j_state.params), batch_stats=_to64(j_state.batch_stats), tx=j_state.tx
    )
    state = create_frontend_state(config, "cpu")
    loaded = frontend_state_dict(j_state.params, j_state.batch_stats)
    loaded.update({k: v for k, v in state.network.state_dict().items() if k.endswith("num_batches_tracked")})
    state.network.load_state_dict(loaded)
    train_step, eval_step = make_frontend_train_step(state, config)

    batches = []
    for seed in (11, 12, 13):
        key = jax.random.key(seed)
        windows, t_windows = _windows(key, j_config)
        render_key = jax.random.fold_in(key, 1)
        images = jf.render_scene_batch(render_key, windows, j_config.render)
        batches.append((windows, images, t_windows, _jax_render_draws(render_key, B, 4, 8, j_config.render)))
    current = {}
    monkeypatch.setattr(jf, "generate_vo_window_batch", lambda *_: current["windows"])
    monkeypatch.setattr(jf, "render_scene_batch", lambda *_: current["images"])
    j_train_step, j_eval_step = jf.make_frontend_train_step(network, j_config)

    with jax.disable_jit():  # each call reads the injected batch
        for windows, images, t_windows, noise in batches[:2]:
            current.update(windows=windows, images=images)
            j_state, j_metrics = j_train_step(j_state, jax.random.key(0))
            metrics = train_step(windows=t_windows, noise=noise)
            for name, value in j_metrics.items():
                np.testing.assert_allclose(float(metrics[name]), float(value), rtol=1e-10, atol=1e-12, err_msg=name)
            params, stats = frontend_state_to_flax(state.network.state_dict())
            _close_trees(params, j_state.params, 1e-9, relative_to_largest=True)
            _close_trees(stats, j_state.batch_stats, 1e-10)
        windows, images, t_windows, noise = batches[2]
        current.update(windows=windows, images=images)
        j_val = j_eval_step(j_state, jax.random.key(0))
    val = eval_step(windows=t_windows, noise=noise)
    assert state.step == 2 and set(val) == set(j_val)
    for name, value in j_val.items():
        np.testing.assert_allclose(float(val[name]), float(value), rtol=1e-8, atol=1e-12, err_msg=name)


def test_fit_frontend_one_epoch_on_the_cpu():
    _, config = _experiments(batches_per_epoch=2, val_batches=1, epochs=1)
    logged = []
    state, history = fit_frontend(config, device="cpu", log_fn=lambda *record: logged.append(record))
    assert [split for split, _, _ in logged] == ["train", "val"] and state.step == 2
    train, val = history["train"][0], history["val"][0]
    assert set(train) == {"loss", "detection_loss", "score_loss", "match_loss", "epoch_seconds"}
    assert set(val) == {"loss", "detection_loss", "score_loss", "match_loss", "match_inlier_rate"}
    assert all(np.isfinite(v) for v in list(train.values()) + list(val.values()))
    stats = state.network.detector.enc2.norm.running_var
    assert not torch.all(stats == 1.0)  # the train steps moved the statistics


@pytest.mark.parametrize("warmup", [200, 3], ids=["recipe_warmup", "short_warmup"])
def test_frontend_schedule_matches_optax(warmup):
    _, config = _experiments(warmup_steps=warmup, epochs=3, batches_per_epoch=4)
    schedule = create_frontend_state(config, "cpu").schedule
    total = max(config.epochs * config.batches_per_epoch, 2)
    w = min(warmup, total // 2)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=config.learning_rate, warmup_steps=w, decay_steps=max(total, w + 1),
        end_value=0.1 * config.learning_rate,
    )
    np.testing.assert_allclose([schedule(k) for k in range(total + 3)], [float(want(k)) for k in range(total + 3)],
                               rtol=1e-12, atol=1e-18)


def test_flax_style_init_of_the_convolutions():
    config = FrontendExperiment(descriptor_channels=64)
    state = create_frontend_state(config, "cpu")
    frontend = state.network
    conv = frontend.detector.enc2.conv
    fan_in = conv.weight[0].numel()  # kh * kw * cin = 3 * 3 * 64
    assert fan_in == 576
    np.testing.assert_allclose(float(conv.weight.detach().std()), 1.0 / np.sqrt(fan_in), rtol=0.05)
    assert float(conv.weight.abs().max()) <= 2.0 / np.sqrt(fan_in) / 0.87962566103423978 + 1e-6
    assert torch.all(conv.bias == 0) and frontend.detector.up1.upscale.smooth.bias is None
    norm = frontend.detector.enc2.norm
    assert torch.all(norm.weight == 1) and torch.all(norm.bias == 0) and torch.all(norm.running_var == 1)


def test_cli_fit_frontend_checkpoint_reads_in_jax_and_the_port(tmp_path, capsys):
    metrics = tmp_path / "m.jsonl"
    argv = ["fit-frontend", "--platform", "cpu", "--epochs", "1", "--batch-size", "2", "--batches-per-epoch", "1",
            "--image-size", str(SIZE), "--points", "6", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--metrics-file", str(metrics), "--registry-dir", str(tmp_path / "runs")]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    final = json.loads(lines[-1])["final"]
    assert "match_inlier_rate" in final and all(np.isfinite(list(final.values())))
    assert lines[-2] == f"checkpoint: {tmp_path / 'ckpt' / 'checkpoint_1'}"  # an Orbax directory, as the JAX CLI's
    # the registered run's manifest heads the file (and sits in the
    # checkpoint directory), then a train and a val record
    records = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert len(records) == 3 and records[0]["run"]["tags"] == {"command": "fit-frontend"}
    run_manifest = json.loads((tmp_path / "ckpt" / "run_manifest.json").read_text())
    assert run_manifest["run_id"] == records[0]["run"]["run_id"] == records[2]["run_id"]
    arch = json.loads((tmp_path / "ckpt" / "frontend_config.json").read_text())
    assert arch == {"num_select": 6, "descriptor_channels": 64, "embedding_size": 64, "image_size": SIZE}

    restored = j_restore_checkpoint(str(tmp_path / "ckpt"))
    frontend, render = load_frontend(tmp_path / "ckpt", device="cpu")
    assert render.image_size == SIZE and frontend.num_select == 6 and not frontend.training
    images = np.random.default_rng(0).uniform(size=(2, 4, SIZE, SIZE, 3)).astype(np.float32)
    j_out = JVOFrontend(num_select=6).apply(
        {"params": restored["params"], "batch_stats": restored["batch_stats"]}, jnp.asarray(images)
    )
    out = frontend(torch.tensor(images))
    for name in ("points", "scores", "matched", "matches"):
        np.testing.assert_allclose(to_numpy(getattr(out, name)), np.asarray(getattr(j_out, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
