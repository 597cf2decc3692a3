"""The eval slice as a whole: the port's ``CalibrationNetwork`` against the
JAX package's, with the JAX weights carried across by ``convert.py``.

* Small transformer network (2 layers, embed 32), 8 scenes, 2 restarts,
  10 BFGS iterations, float64: guesses to 1e-10, solved parameters to
  1e-6 relative to their scale (rounding compounds over the solve).  The
  JAX side's fused objective is its Pallas kernel's function (the
  ``jax.vjp`` of the channel-major objective with the polynomial atan2,
  which the kernel evaluates); on the CPU the JAX package would otherwise
  take the exact-atan2 jnp path.
* MLP head with BatchNorm running statistics: guesses to 1e-10 (float64).
* The real ``calibration_transformer_v2_600.pkl`` (6 layers, embed 256, 8
  heads), loaded without JAX: the head's guesses on 4 scenes to 1e-4
  relative to their scale in float32 (six layers of float32 products
  summed in another order).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import davo_tpu.models.calibration_network as j_network_module
from davo_tpu.camera.calibration_fast import calibration_error_channel_major as j_objective
from davo_tpu.data import SceneConfig as JSceneConfig
from davo_tpu.data import generate_batch as j_generate_batch
from davo_tpu.models import CalibrationNetwork as JNetwork
from davo_tpu.models.calibration_network import CalibrationTransformerHead as JTransformerHead
from davo_tpu.solve import BFGSConfig as JBFGSConfig
from davo_tpu_torch.models import (
    CalibrationNetwork,
    flax_to_state_dict,
    load_calibration_network,
    load_numpy_checkpoint,
)
from davo_tpu_torch.solve import BFGSConfig
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
V2_600 = REPO / "artifacts" / "calibration_transformer_v2_600.pkl"
V4_1800 = REPO / "artifacts" / "calibration_transformer_v4_1800.pkl"
V5_TOKENS8 = REPO / "artifacts" / "calibration_transformer_v5_tokens8.pkl"
M, N = 4, 8
P = 3 + 3 * N + 6 * (M - 1)
SOLVER = dict(error_threshold=1e-7, iterations=10, line_search_iterations=50)


def _scenes(batch, seed=0, dtype=jnp.float64):
    scenes = jax.jit(lambda k: j_generate_batch(k, batch, JSceneConfig(dtype=dtype)))(jax.random.key(seed))
    return np.asarray(scenes.projected_points), np.asarray(scenes.visibility_mask), scenes


def _kernel_function_objective(projected_points, visibility_mask, **_):
    """The function the JAX package's fused value+gradient kernel computes
    (polynomial atan2), as a jnp closure pair."""
    dtype = jnp.promote_types(projected_points.dtype, jnp.float32)
    u = jnp.transpose(projected_points[..., 0], (1, 2, 0)).astype(dtype)
    v = jnp.transpose(projected_points[..., 1], (1, 2, 0)).astype(dtype)
    vis = jnp.transpose(visibility_mask, (1, 2, 0)).astype(dtype)

    def error_fn(params):
        return j_objective(params.T, u, v, vis)

    def value_and_grad_fn(params):
        err, pullback = jax.vjp(lambda q: j_objective(q, u, v, vis, approx_atan2=True), params.T)
        return err, pullback(jnp.ones_like(err))[0].T

    return error_fn, value_and_grad_fn


def test_transformer_network_eval_matches(monkeypatch):
    monkeypatch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
    pts, vis, _ = _scenes(8)
    kwargs = dict(
        num_views=M, num_points=N, hidden_size=32, head="transformer",
        transformer_layers=2, transformer_heads=4, num_restarts=2,
    )
    j_net = JNetwork(solver=JBFGSConfig(**SOLVER), fused_objective=True, **kwargs)
    variables = j_net.init(jax.random.key(1), jnp.asarray(pts), jnp.asarray(vis))
    variables = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), variables)
    j_out, j_err = jax.jit(lambda p, v: j_net.apply(variables, p, v, return_error=True))(
        jnp.asarray(pts), jnp.asarray(vis)
    )
    j_guess = JTransformerHead(num_outputs=P, num_views=M, num_points=N, embed_dim=32, num_layers=2, num_heads=4).apply(
        {"params": variables["params"]["initial_estimator"]}, jnp.asarray(pts), jnp.asarray(vis)
    )
    # the restart noise JAX draws without a "restarts" rng
    draws = np.asarray(jax.random.normal(jax.random.key(0), (8, 1, P), jnp.float64))

    net = CalibrationNetwork(solver=BFGSConfig(**SOLVER), device="cpu", dtype=torch.float64, **kwargs)
    net.load_state_dict(flax_to_state_dict(variables["params"]))
    t_pts, t_vis = torch.tensor(pts), torch.tensor(vis)
    np.testing.assert_allclose(net.guess(t_pts, t_vis).detach().numpy(), np.asarray(j_guess), rtol=1e-10, atol=1e-10)
    t_out, t_err = net(t_pts, t_vis, restart_draws=torch.tensor(draws), return_error=True)
    scale = float(np.max(np.abs(np.asarray(j_out))))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(t_err.numpy(), np.asarray(j_err), rtol=1e-6, atol=1e-9)
    assert float(t_err.mean()) < 0.5 * float(
        j_network_module.calibration_error(j_guess, jnp.asarray(pts), jnp.asarray(vis)).mean()
    )


def test_mlp_head_guess_matches():
    pts, vis, _ = _scenes(8, seed=2)
    j_net = JNetwork(num_views=M, num_points=N, hidden_size=24, solver=JBFGSConfig(**SOLVER))
    variables = j_net.init(jax.random.key(3), jnp.asarray(pts), jnp.asarray(vis))
    variables = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), variables)
    rng = np.random.default_rng(0)
    stats = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.uniform(0.5, 1.5, size=x.shape)), variables["batch_stats"]
    )
    head = j_network_module.CalibrationMLPHead(num_outputs=P, hidden_size=24)
    j_guess = head.apply(
        {"params": variables["params"]["initial_estimator"], "batch_stats": stats["initial_estimator"]},
        jnp.asarray(pts).reshape(8, -1),
    )
    net = CalibrationNetwork(M, N, hidden_size=24, device="cpu", dtype=torch.float64)
    state = flax_to_state_dict(variables["params"], stats)
    state.update({k: v for k, v in net.state_dict().items() if k.endswith("num_batches_tracked")})
    net.load_state_dict(state)
    guess = net.guess(torch.tensor(pts), torch.tensor(vis)).detach().numpy()
    np.testing.assert_allclose(guess, np.asarray(j_guess), rtol=1e-10, atol=1e-10)


def test_v2_600_head_matches_jax():
    pts, vis, _ = _scenes(4, seed=5, dtype=jnp.float32)
    checkpoint = load_numpy_checkpoint(V2_600)
    assert str(checkpoint["config"]) == "transformer6x256h8_fovcurriculum600"
    j_head = JTransformerHead(num_outputs=P, num_views=M, num_points=N, embed_dim=256, num_layers=6, num_heads=8)
    j_guess = np.asarray(
        jax.jit(j_head.apply)({"params": checkpoint["params"]["initial_estimator"]}, jnp.asarray(pts), jnp.asarray(vis))
    )
    net = load_calibration_network(
        V2_600, device="cpu", num_views=M, num_points=N, hidden_size=256,
        head="transformer", transformer_layers=6, transformer_heads=8,
    )
    guess = net.guess(torch.tensor(pts), torch.tensor(vis)).detach().numpy()
    scale = float(np.max(np.abs(j_guess)))
    np.testing.assert_allclose(guess, j_guess, rtol=1e-4, atol=1e-4 * scale)


def test_port_loads_weights_without_jax():
    """The port, every module imported (the training ones too), loading the
    v2_600 and v4_1800 checkpoints, reading the v5_tokens8 architecture and
    the front end's weights in a fresh interpreter, pulls in no JAX, flax,
    optax or davo_tpu module."""
    code = (
        "import sys\n"
        "import davo_tpu_torch, davo_tpu_torch.models, davo_tpu_torch.solve, davo_tpu_torch.data\n"
        "import davo_tpu_torch.ops, davo_tpu_torch.ops.attention, davo_tpu_torch.train\n"
        "import davo_tpu_torch.models.detector, davo_tpu_torch.models.matcher\n"
        "import davo_tpu_torch.models.vo_frontend, davo_tpu_torch.data.rendering\n"
        "import davo_tpu_torch.data.vo_windows, davo_tpu_torch.train.frontend\n"
        "import davo_tpu_torch.cli, davo_tpu_torch.train.calibration, davo_tpu_torch.ops.bfgs_update_variants\n"
        "import davo_tpu_torch.scripts.check_fused_objective, davo_tpu_torch.scripts.time_fused_objective\n"
        "import davo_tpu_torch.scripts.tune_bfgs_kernel, davo_tpu_torch.train.metrics\n"
        "import davo_tpu_torch.train.checkpoint, davo_tpu_torch.train.presets, davo_tpu_torch.camera\n"
        "import davo_tpu_torch.models.convert, davo_tpu_torch.solve.bfgs\n"
        "from davo_tpu_torch.train import fit, fit_fov_curriculum, create_train_state, make_train_step, MetricsLogger\n"
        "from davo_tpu_torch.camera import basin_score, calibration_residuals\n"
        "from davo_tpu_torch.models import permutation_restart_guesses, state_dict_to_flax, flax_style_init_\n"
        f"ckpt = davo_tpu_torch.models.load_numpy_checkpoint({str(V2_600)!r})\n"
        "assert ckpt['params']['initial_estimator']['head']['kernel'].shape == (256, 45)\n"
        f"ckpt = davo_tpu_torch.models.load_numpy_checkpoint({str(V4_1800)!r})\n"
        "assert ckpt['params']['initial_estimator']['head']['kernel'].shape == (448, 45)\n"
        f"arch = davo_tpu_torch.models.checkpoint_architecture(davo_tpu_torch.models.load_numpy_checkpoint({str(V5_TOKENS8)!r})['params'])\n"
        "assert arch['guess_tokens'] == 8 and arch['hidden_size'] == 384, arch\n"
        "frontend, render = davo_tpu_torch.models.load_frontend(device='cpu')\n"
        "assert render.image_size == 96 and frontend.num_select == 8\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'davo_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


def test_numpy_only_loader_refuses_other_globals(tmp_path):
    import pickle

    path = tmp_path / "bad.pkl"
    path.write_bytes(pickle.dumps({"params": {"x": np.zeros(2)}, "when": __import__("datetime").date(2020, 1, 1)}))
    with pytest.raises(pickle.UnpicklingError, match="datetime"):
        load_numpy_checkpoint(path)


def test_training_mode_not_ported():
    """The training forward runs: in ``train()`` mode the network solves one
    start through the unrolled differentiable solve and keeps the graph
    back to the head's weights.  What stays unported of training (the
    front end's step, L-BFGS) lives outside this module."""
    net = CalibrationNetwork(M, N, hidden_size=16, device="cpu", solver=BFGSConfig(training_iterations=2))
    net.train()
    out = net(torch.rand(4, M, N, 2), torch.ones(4, M, N, dtype=torch.bool), generator=torch.Generator().manual_seed(0))
    (grad,) = torch.autograd.grad(out.sum(), net.initial_estimator.head.weight)
    assert out.shape == (4, P) and torch.isfinite(grad).all() and grad.abs().sum() > 0
