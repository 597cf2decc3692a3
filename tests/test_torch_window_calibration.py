"""The slice as a whole: learned-match window calibration, the port against
the JAX package (the window level of ``vo-eval --matches learned``).

Two VO windows rendered by the JAX package at 96 px go through the front
end (``frontend_v4`` weights, every gate off: top-k anchor selection,
as the front end was validated) and the window solver
(``artifacts/vo_windows_transformer_v2_600.pkl``: transformer head, embed
256, 6 layers, 8 heads; strong Wolfe, 10 iterations, 2 restarts, error
selection) on both sides, in float64.  The JAX side's fused objective is
its Pallas kernel's function (polynomial atan2), as it runs on the TPU;
the port's CPU path runs the plain versions of K1, K2 and K3.  The
learned matches agree to 1e-9 (visibility identical), the guesses to
1e-9, the solved parameters to 1e-6 relative to their scale and the final
errors to 1e-6 (rounding compounds over the solve, as in the oracle-match
slice's test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import davo_tpu.models.calibration_network as j_network_module
from davo_tpu.data import VOWindowConfig as JWindowConfig
from davo_tpu.data import generate_vo_window_batch as j_generate_vo_window_batch
from davo_tpu.data.rendering import RenderConfig as JRenderConfig
from davo_tpu.models import CalibrationNetwork as JNetwork
from davo_tpu.models.calibration_network import CalibrationTransformerHead as JTransformerHead
from davo_tpu.models.vo_frontend import VOFrontend as JVOFrontend
from davo_tpu.solve import BFGSConfig as JBFGSConfig
from davo_tpu.train.frontend import render_scene_batch as j_render_scene_batch
from davo_tpu_torch.models import FRONTEND_V4, load_calibration_network, load_frontend, load_frontend_npz
from davo_tpu_torch.models.convert import load_numpy_checkpoint
from davo_tpu_torch.solve import BFGSConfig
from tests.test_torch_calibration_network import REPO, _kernel_function_objective
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

WINDOW_SOLVER = REPO / "artifacts" / "vo_windows_transformer_v2_600.pkl"
M, N, P = 4, 8, 45
SOLVER = dict(error_threshold=1e-7, iterations=10, line_search_iterations=50)
NETWORK = dict(
    num_views=M, num_points=N, hidden_size=256, head="transformer",
    transformer_layers=6, transformer_heads=8, num_restarts=2,
)


def test_learned_match_window_calibration_matches_jax(monkeypatch):
    monkeypatch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
    key = jax.random.key(7)
    windows = j_generate_vo_window_batch(key, 2, JWindowConfig(dtype=jnp.float64))
    images = j_render_scene_batch(jax.random.fold_in(key, 1), windows, JRenderConfig(image_size=96, dtype=jnp.float64))

    # JAX: the front end, then the window solve on its matches
    fe_vars = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), load_frontend_npz(FRONTEND_V4))
    j_fe = JVOFrontend().apply(fe_vars, images)
    checkpoint = load_numpy_checkpoint(WINDOW_SOLVER)
    assert str(checkpoint["config"]) == "transformer6x256h8_vowindows600"
    variables = {"params": jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), checkpoint["params"])}
    j_net = JNetwork(solver=JBFGSConfig(**SOLVER), fused_objective=True, **NETWORK)
    j_params, j_err = jax.jit(lambda p, v: j_net.apply(variables, p, v, return_error=True))(
        j_fe.matches, j_fe.match_visibility
    )
    j_head = JTransformerHead(num_outputs=P, num_views=M, num_points=N, embed_dim=256, num_layers=6, num_heads=8)
    j_guess = j_head.apply({"params": variables["params"]["initial_estimator"]}, j_fe.matches, j_fe.match_visibility)
    # the restart noise JAX draws without a "restarts" rng
    draws = torch.tensor(np.asarray(jax.random.normal(jax.random.key(0), (2, 1, P), jnp.float64)))

    # the port
    frontend, render = load_frontend(device="cpu", dtype=torch.float64)
    assert render.image_size == 96
    out = frontend(torch.tensor(np.asarray(images)))
    np.testing.assert_allclose(to_numpy(out.matches), np.asarray(j_fe.matches), rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(to_numpy(out.match_visibility), np.asarray(j_fe.match_visibility))
    net = load_calibration_network(
        WINDOW_SOLVER, device="cpu", dtype=torch.float64, solver=BFGSConfig(**SOLVER), **NETWORK
    )
    guess = net.guess(out.matches, out.match_visibility)
    np.testing.assert_allclose(to_numpy(guess), np.asarray(j_guess), rtol=1e-9, atol=1e-9)
    params, err = net(out.matches, out.match_visibility, restart_draws=draws, return_error=True)
    scale = float(np.max(np.abs(np.asarray(j_params))))
    np.testing.assert_allclose(to_numpy(params), np.asarray(j_params), rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(to_numpy(err), np.asarray(j_err), rtol=1e-6, atol=1e-9)
    assert torch.isfinite(params).all()
