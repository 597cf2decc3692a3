"""Basin selection and the restart proposals: the port against the JAX
package, float64.

* ``basin_score`` and ``calibration_residuals`` to 1e-12 on parameters
  with implausible focals (both sides of the bounds), principal points
  beyond 0.5, visible points behind a camera, and the anchor term.
* ``permutation_restart_guesses`` with the JAX permutations injected, to
  1e-12 on a point-order-sensitive head; the un-permutation round trip to
  1e-12 (the head's order-free sums round in another order), on a head
  whose world points follow their own observations.
* The E-token transformer head against flax to 1e-10.
* The network's eval forward against ``CalibrationNetwork.apply`` for each
  proposal with "error" selection (``test_torch_basin_selection.py`` has
  "basin"; tiny transformer: 2 layers, width 32; 8 scenes, 3 restarts, a
  10-iteration solve with Armijo backtracking), with the JAX draws injected (its
  restart key is ``key(0)`` without a ``restarts`` rng): the permutations
  ``permutation(fold_in(key, e), N)``, the input jitter
  ``normal(fold_in(key, e), shape)``, the noise ``normal(key, shape)``.
  Solved parameters to 1e-6 relative to their scale, errors to 1e-6 (as
  ``test_torch_calibration_network.py``; both fused objectives are the
  kernel's function, the polynomial atan2).
* Each incompatible setting raises, with the JAX package's message
  (``davo_tpu/models/calibration_network.py:267-271, 352-356, 368-373``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import davo_tpu.models.calibration_network as j_network_module
from davo_tpu.camera import BasinScoreConfig as JBasinScoreConfig
from davo_tpu.camera import basin_score as j_basin_score
from davo_tpu.camera.calibration import calibration_residuals as j_calibration_residuals
from davo_tpu.data import SceneConfig as JSceneConfig
from davo_tpu.data import generate_batch as j_generate_batch
from davo_tpu.models import CalibrationNetwork as JNetwork
from davo_tpu.models.calibration_network import CalibrationTransformerHead as JTransformerHead
from davo_tpu.solve import BFGSConfig as JBFGSConfig
from davo_tpu_torch.camera import BasinScoreConfig, basin_score, calibration_residuals
from davo_tpu_torch.models import CalibrationNetwork, CalibrationTransformerHead, flax_to_state_dict
from davo_tpu_torch.models import permutation_restart_guesses
from davo_tpu_torch.solve import BFGSConfig
from tests.test_torch_calibration_network import _kernel_function_objective
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

M, N, B, R = 4, 8, 8, 3
P = 3 + 3 * N + 6 * (M - 1)
# backtracking: the restarts and their selection do not depend on the
# search, and its JAX program compiles faster than the Wolfe machine's
SOLVER = dict(error_threshold=1e-7, iterations=10, line_search_iterations=20, line_search_method="backtracking")
TINY = dict(num_views=M, num_points=N, hidden_size=32, head="transformer", transformer_layers=2, transformer_heads=4)


@pytest.fixture(scope="module")
def scenes():
    batch = jax.jit(lambda k: j_generate_batch(k, B, JSceneConfig(dtype=jnp.float64)))(jax.random.key(21))
    return np.asarray(batch.projected_points), np.asarray(batch.visibility_mask)


def _implausible_parameters(rng):
    """Parameters across every penalty: focals below and above the bounds,
    centres beyond 0.5, negative depths, a view that sees nothing."""
    params = rng.normal(size=(B, P))
    params[:, 0] = np.linspace(-3.0, 5.0, B)  # elu(f) + 1 from 0.05 to 6
    params[:, 1:3] = rng.uniform(-1.0, 1.0, size=(B, 2))
    params[:, 5 : 3 + 3 * N : 3] = rng.uniform(-1.0, 2.0, size=(B, N))  # some points behind view 1
    return params


def test_basin_score_and_residuals_match(scenes):
    pts, vis = scenes
    rng = np.random.default_rng(0)
    params = _implausible_parameters(rng)
    vis = vis.copy()
    vis[0, 1] = False  # a view of one scene that sees nothing
    anchor = rng.normal(size=(B,))
    t_args = (torch.tensor(params), torch.tensor(pts), torch.tensor(vis))
    j_args = (jnp.asarray(params), jnp.asarray(pts), jnp.asarray(vis))
    np.testing.assert_allclose(
        calibration_residuals(t_args[0], t_args[1]).numpy(), np.asarray(j_calibration_residuals(*j_args[:2])),
        rtol=1e-12, atol=1e-14,
    )
    for weights in (dict(), dict(anchor_weight=0.5, depth_margin=0.2), dict(focal_weight=3.0, centre_bound=0.2)):
        got = basin_score(*t_args, BasinScoreConfig(**weights), anchor_log_focal=torch.tensor(anchor))
        want = j_basin_score(*j_args, JBasinScoreConfig(**weights), anchor_log_focal=jnp.asarray(anchor))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14, err_msg=str(weights))
    # every penalty is active somewhere, so the score exceeds the error there
    error = basin_score(*t_args, BasinScoreConfig(focal_weight=0, centre_weight=0, depth_weight=0))
    assert bool((basin_score(*t_args) > error).all())


def _jax_permutations(restarts, key=jax.random.key(0)):
    return np.stack(
        [np.asarray(jax.random.permutation(jax.random.fold_in(key, e), N)) for e in range(1, restarts)]
    )


def test_permutation_guesses_match(scenes):
    pts, vis = scenes
    rng = np.random.default_rng(1)
    weights = rng.normal(size=(M * N * 2 + M * N, P)) / 10.0

    def j_head(pixels, visibility):
        return jnp.concatenate([pixels.reshape(B, -1), visibility.reshape(B, -1)], axis=-1) @ weights

    def t_head(pixels, visibility):
        return torch.cat([pixels.reshape(B, -1), visibility.reshape(B, -1).double()], dim=-1) @ torch.tensor(weights)

    raw = np.asarray(j_head(jnp.asarray(pts), jnp.asarray(vis, jnp.float64)))
    key = jax.random.key(5)
    want = j_network_module.permutation_restart_guesses(
        lambda p, v: j_head(p, v.astype(jnp.float64)), jnp.asarray(pts), jnp.asarray(vis), jnp.asarray(raw), N, key, 4
    )
    got = permutation_restart_guesses(
        t_head, torch.tensor(pts), torch.tensor(vis), torch.tensor(raw), torch.tensor(_jax_permutations(4, key))
    )
    assert got.shape == (B, 4, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def test_permutation_round_trip(scenes):
    """A head whose point slices follow their own observations (and whose
    other entries are order-free) gives the same start for every
    permutation once the points are scattered back."""
    pts, vis = (torch.tensor(x) for x in scenes)

    def head(pixels, visibility):
        first = pixels[:, 0]  # (B, N, 2)
        points = torch.stack([first[..., 0], first[..., 1], first[..., 0] * first[..., 1]], dim=-1)
        summary = pixels.sum(dim=(1, 2))  # order-free
        rest = summary.repeat(1, (P - 3 - 3 * N) // 2 + 1)[:, : P - 3 - 3 * N]
        return torch.cat([summary[:, :1].repeat(1, 3), points.reshape(B, -1), rest], dim=-1)

    permutations = torch.stack([torch.randperm(N, generator=torch.Generator().manual_seed(i)) for i in range(5)])
    starts = permutation_restart_guesses(head, pts, vis, head(pts, vis), permutations)
    for e in range(1, 6):
        torch.testing.assert_close(starts[:, e], starts[:, 0], rtol=0, atol=1e-12)


def test_token_head_matches_flax(scenes):
    pts, vis = scenes
    j_head = JTransformerHead(num_outputs=P, num_views=M, num_points=N, embed_dim=32, num_layers=2, num_heads=4,
                              num_tokens=3)
    variables = jax.jit(j_head.init)(jax.random.key(2), jnp.asarray(pts), jnp.asarray(vis))
    variables = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), variables)
    want = np.asarray(jax.jit(j_head.apply)(variables, jnp.asarray(pts), jnp.asarray(vis)))
    head = CalibrationTransformerHead(P, M, N, embed_dim=32, num_layers=2, num_heads=4, num_tokens=3).double()
    state = flax_to_state_dict({"initial_estimator": variables["params"]})
    head.load_state_dict({k[len("initial_estimator."):]: v for k, v in state.items()})
    got = head(torch.tensor(pts), torch.tensor(vis)).detach().numpy()
    assert got.shape == want.shape == (B, 3, P)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def network_case(scenes, monkeypatch, proposals, selection, anchor, tokens):
    """The port's eval forward against ``CalibrationNetwork.apply`` for one
    proposal and selection, the JAX draws injected.  The weights come from
    the head's own ``init`` (the network's would run the whole solve)."""
    monkeypatch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
    pts, vis = scenes
    setting = dict(num_restarts=R, restart_proposals=proposals, selection=selection, guess_tokens=tokens, **TINY)
    j_net = JNetwork(
        solver=JBFGSConfig(**SOLVER), fused_objective=True, basin=JBasinScoreConfig(anchor_weight=anchor), **setting
    )
    j_head = JTransformerHead(num_outputs=P, num_views=M, num_points=N, embed_dim=32, num_layers=2, num_heads=4,
                              num_tokens=tokens)
    head_params = jax.jit(j_head.init)(jax.random.key(3), jnp.asarray(pts), jnp.asarray(vis))["params"]
    variables = {"params": jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), {"initial_estimator": head_params})}
    j_out, j_err = jax.jit(lambda p, v: j_net.apply(variables, p, v, return_error=True))(
        jnp.asarray(pts), jnp.asarray(vis)
    )

    key = jax.random.key(0)  # JAX's restart key without a "restarts" rng
    draws = {}
    if proposals == "noise":
        draws["restart_draws"] = np.asarray(jax.random.normal(key, (B, R - 1, P), jnp.float64))
    elif proposals == "tokens" and R > tokens:
        draws["restart_draws"] = np.asarray(jax.random.normal(key, (B, R - tokens, P), jnp.float64))
    elif proposals == "permutation":
        draws["restart_permutations"] = _jax_permutations(R)
    elif proposals == "input_noise":
        draws["input_draws"] = np.stack(
            [np.asarray(jax.random.normal(jax.random.fold_in(key, e), pts.shape, jnp.float64)) for e in range(1, R)]
        )
    net = CalibrationNetwork(
        solver=BFGSConfig(**SOLVER), basin=BasinScoreConfig(anchor_weight=anchor), device="cpu",
        dtype=torch.float64, **setting,
    )
    net.load_state_dict(flax_to_state_dict(variables["params"]))
    out, err = net(torch.tensor(pts), torch.tensor(vis), return_error=True,
                   **{k: torch.tensor(v) for k, v in draws.items()})
    scale = float(np.max(np.abs(np.asarray(j_out))))
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(err.numpy(), np.asarray(j_err), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize(
    "proposals,tokens",
    [("noise", 1), ("permutation", 1), ("input_noise", 2), ("tokens", 2)],  # 2 tokens: the third restart is noise
)
def test_network_eval_matches_with_error_selection(scenes, monkeypatch, proposals, tokens):
    network_case(scenes, monkeypatch, proposals, "error", 0.0, tokens)


def test_basin_selection_picks_a_plausible_restart():
    """Between an implausible start of zero error and a plausible one, the
    basin score keeps the plausible one where the error would not."""
    pts = torch.rand(1, M, N, 2, dtype=torch.float64)
    vis = torch.ones(1, M, N, dtype=torch.float64)
    params = torch.tensor(_implausible_parameters(np.random.default_rng(3))[:2])[None]  # (1, 2, P)
    params[0, 1, 0] = 0.5  # plausible focal
    params[0, 1, 1:3] = 0.0
    params[0, 1, 5 : 3 + 3 * N : 3] = 2.0  # in front of every camera
    score = basin_score(params, pts[:, None], vis[:, None])
    assert int(torch.argmin(score, dim=-1)) == 1


# the JAX package's messages (davo_tpu/models/calibration_network.py)
INCOMPATIBLE = [
    (dict(head="mlp", guess_tokens=2), "guess_tokens > 1 requires the transformer head"),
    (dict(restart_proposals="tokens"), "restart_proposals='tokens' requires guess_tokens > 1"),
    (
        dict(restart_proposals="permutation", guess_tokens=2),
        r"restart_proposals='permutation' is incompatible with guess_tokens > 1 \(use 'tokens'\)",
    ),
    (dict(restart_proposals="shuffle"), "Unknown restart_proposals: 'shuffle'"),
    (dict(selection="vote"), "Unknown selection: 'vote'"),
]


@pytest.mark.parametrize("setting,match", INCOMPATIBLE)
def test_incompatible_settings_raise(scenes, setting, match):
    pts, vis = scenes
    kwargs = dict(TINY, hidden_size=8, transformer_layers=1, num_restarts=2, **setting)
    with pytest.raises(ValueError, match=match):
        net = CalibrationNetwork(solver=BFGSConfig(iterations=1), device="cpu", **kwargs)
        net(torch.tensor(pts[:2], dtype=torch.float32), torch.tensor(vis[:2]))
