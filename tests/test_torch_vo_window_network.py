"""Windowed learned VO with a guess network: the port's stacked window
solves against the JAX package's per-window calls, in float64.

A tiny transformer head (2 restarts, 10 BFGS iterations) whose weights
``state_dict_to_flax`` carries across; the JAX side's fused objective is
its Pallas kernel's function, the plain version of the port's K2.  Every
window of a 14-frame orbit (11 windows of 4 at stride 1) starts from
window 0's truth.  JAX solves a window a call; the port stacks them on the
batch axis, so the comparison is also the stacked call against the
per-window loop, and one test holds the stacked call against the port's
own loop.  Poses are compared as rotation matrices and translations.

Tolerances: the windows and their stitch 1e-6 (10 iterations of line
search on each side, rounding compounded); the stacked call against the
port's own loop 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vo_accumulator import _truth_vector
from tests.test_torch_vo_incremental import J, T, _assert_poses_close, _port_config, _t
from tests.test_torch_vo_windows import POINTS, _case
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401


def _tiny_pair(head_bias, restarts=2, iterations=10):
    """The transformer-head network at a tiny width in both packages
    (float64; the port's flax-style init carried to JAX by
    ``state_dict_to_flax``, the output layer's kernel scaled to 1e-3 and
    its bias ``head_bias``), ``restarts`` noise restarts, ``iterations``
    BFGS iterations.  The port's guess function gives every row JAX's
    restart draw (``normal(key(0))`` of a one-row call, as the JAX network
    draws without a ``restarts`` rng).  The JAX side's fused objective
    must be its kernel's function (the caller patches it)."""
    from davo_tpu.models import CalibrationNetwork as JNetwork
    from davo_tpu.solve import BFGSConfig as JBFGSConfig
    from davo_tpu_torch.models import CalibrationNetwork, load_flax_weights, state_dict_to_flax
    from davo_tpu_torch.solve import BFGSConfig

    solver = dict(error_threshold=1e-7, iterations=iterations, line_search_iterations=20)
    arch = dict(num_views=4, num_points=POINTS, hidden_size=16, head="transformer", transformer_layers=1,
                transformer_heads=2, num_restarts=restarts)
    net = CalibrationNetwork(solver=BFGSConfig(**solver), device="cpu", dtype=torch.float64, **arch)
    params, stats = state_dict_to_flax(net.state_dict(), num_heads=2)
    head = params["initial_estimator"]["head"]
    head["kernel"] = 1e-3 * np.asarray(head["kernel"])
    head["bias"] = np.asarray(head_bias, np.float64).reshape(-1)
    load_flax_weights(net, params, stats)
    variables = {"params": params, "batch_stats": stats}
    j_net = JNetwork(solver=JBFGSConfig(**solver), fused_objective=True, **arch)
    draws = _t(np.asarray(jax.random.normal(jax.random.key(0), (1, restarts - 1, head["bias"].size), jnp.float64)))

    def t_guess(pw, vw):
        return net(pw, vw, restart_draws=draws.expand(pw.shape[0], -1, -1))

    return jax.jit(lambda pw, vw: j_net.apply(variables, pw, vw)), t_guess


@pytest.fixture(scope="module")
def tiny():
    """The orbit (11 windows) and the tiny networks, every window started
    from window 0's truth."""
    import davo_tpu.models.calibration_network as j_network_module
    from tests.test_torch_calibration_network import _kernel_function_objective

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
        j_cfg, _, poses, points, pixels, vis = _case(22)
        yield (j_cfg, pixels, vis) + _tiny_pair(_truth_vector(poses, points, j_cfg))


def test_tiny_network_windows_match_jax(tiny):
    """The tiny network's window solves and one geometry-informed IRLS
    re-solve of every window, then the global stitch."""
    j_cfg, pixels, vis, j_guess, t_guess = tiny
    expected = J.solve_windowed_vo_learned(j_guess, pixels, vis, j_cfg, irls_rounds=1)
    got = T.solve_windowed_vo_learned(t_guess, _t(pixels), _t(vis), _port_config(j_cfg), irls_rounds=1)
    _assert_poses_close(got, expected, 1e-6)


def test_stacked_window_call_equals_the_per_window_loop(tiny):
    """The port's one stacked guess call (and one IRLS round) gives a
    window (the first, a middle and the last) what a call of its own
    gives."""
    j_cfg, pixels, vis, _, t_guess = tiny
    pixels, vis = _t(pixels), _t(vis)
    starts, stacked = T.solve_learned_windows(t_guess, pixels, vis, _port_config(j_cfg), irls_rounds=1)
    one = T.TrajectoryConfig(num_frames=4, num_points=POINTS, window=4, dtype=torch.float64)
    for i in (0, len(starts) // 2, len(starts) - 1):
        s = starts[i]
        _, alone = T.solve_learned_windows(t_guess, pixels[s: s + 4], vis[s: s + 4], one, irls_rounds=1)
        np.testing.assert_allclose(to_numpy(stacked[i]), to_numpy(alone[0]), rtol=0, atol=1e-12)
