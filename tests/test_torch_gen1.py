"""The gen-1 stack against the JAX package's, float64, on inputs drawn with
numpy (or by the JAX package) from a seed.

* ``bfgs_solve_function`` (the protocol solver: strong Wolfe with the
  interpolating zoom, the analytic gradient as the value-and-gradient
  hook, the constrained step) on a ``(B, E) = (3, 2)`` batch of
  ``PinholeCameraModelL1`` objectives: the solved parameters and errors
  to 1e-9 relative (the port's eval solve runs K1's plain version on the
  CPU; rounding compounds over the iterations).
* The solver repair: a ``(B, E, P)`` solve equals its ``(B E, P)``
  flattening exactly, for BFGS in eval and differentiable modes (with 3-D
  keep-masks) and for L-BFGS.
* The guess heads' forwards on the JAX package's initial weights, carried
  across by ``gen1_state_dict``: ``PinholeMLPGuess`` (eval, and training
  with its BatchNorm statistics; the other heads have no training
  behaviour), ``PinholeTransformerGuess`` (with the
  JAX package's fixed pixel projection injected) and
  ``PinholeFixedGuess``: 1e-12; ``gen1_to_flax`` inverts the map.
* ``models/init.py``'s Kaiming initialisers against flax's ``he_normal``
  and ``he_uniform``: support and standard deviation (3 %) of a (256,
  512) kernel.

The gen-1 train steps are in ``test_torch_gen1_train.py``.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu import camera as jcam
from davo_tpu import models as jm
from davo_tpu.data import SceneConfig as JSceneConfig
from davo_tpu.data import generate_batch as j_generate_batch
from davo_tpu.solve import BFGSCameraSolverConfig as JSolverConfig
from davo_tpu.solve import bfgs_solve_function as j_bfgs_solve_function
from davo_tpu_torch import camera as tcam
from davo_tpu_torch import models as tm
from davo_tpu_torch.solve import BFGSCameraSolverConfig, BFGSConfig, LBFGSConfig, bfgs_solve, bfgs_solve_function
from davo_tpu_torch.solve import lbfgs_solve
from davo_tpu_torch.types import CameraViewsAndPoints
from tests.test_torch_pinhole_ba import _pair
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

M, N, B = 3, 5, 8


def _close(actual, expected, tol, name="", scale=None):
    actual, expected = to_numpy(actual), np.asarray(expected)
    if scale is None:
        scale = float(np.max(np.abs(expected)))
    np.testing.assert_allclose(actual, expected, rtol=tol, atol=tol * max(scale, 1e-300), err_msg=name)


def _flat(tree, prefix=""):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}/{key}"))
        return out
    return {prefix: np.asarray(tree)}


def test_protocol_solver_matches_jax():
    (jp, jd), (tp, td) = _pair(11)
    j_model = jcam.PinholeCameraModelL1(jp, jd, jcam.PinholeBAConfig(constrain=True))
    t_model = tcam.PinholeCameraModelL1(tp, td, tcam.PinholeBAConfig(constrain=True))
    j_vec, j_err = jax.jit(lambda model: (lambda out: (out.as_parameters_vector(), out.get_error()))(
        j_bfgs_solve_function(model, JSolverConfig(max_iterations=6))))(j_model)
    t_out = bfgs_solve_function(t_model, BFGSCameraSolverConfig(max_iterations=6))
    assert float(t_out.get_error().sum()) < float(t_model.get_error().sum())
    _close(t_out.as_parameters_vector(), j_vec, 1e-9, "parameters")
    _close(t_out.get_error(), j_err, 1e-9, "error")


def _ba_problem(seed):
    """A ``(B, E, P)`` BA start and its error and value-and-gradient
    functions, and the same on the ``(B E, P)`` flattening."""
    _, (tp, td) = _pair(seed)
    b, e = tp.focal_length.shape
    vec = tcam.ba_params_to_vector(tp)
    m, n = tp.num_views, tp.num_points
    flat_data = tcam.PinholeBAData(*(x.expand((b, e) + x.shape[2:]).reshape((b * e,) + x.shape[2:]) for x in td))

    def funcs(data):
        return (lambda v: tcam.ba_error(tcam.ba_params_from_vector(v, m, n), data),
                lambda v: tcam.ba_error_and_gradient(tcam.ba_params_from_vector(v, m, n), data))

    return vec, funcs(td), vec.reshape(b * e, -1), funcs(flat_data)


@pytest.mark.parametrize("mode", ["bfgs_eval", "bfgs_differentiable", "lbfgs_eval"])
def test_batched_solve_equals_its_flattening(mode):
    vec, (error, value_grad), flat, (flat_error, flat_value_grad) = _ba_problem(12)
    solver = BFGSConfig(error_threshold=1e-9, iterations=4, line_search_iterations=20, drop_path_p=0.3)
    kwargs, flat_kwargs = {}, {}
    if mode == "bfgs_differentiable":
        keep = torch.rand((4,) + vec.shape[:-1], generator=torch.Generator().manual_seed(3)) > 0.3
        kwargs = dict(training=True, keep_masks=keep)
        flat_kwargs = dict(training=True, keep_masks=keep.reshape(4, -1))
    if mode == "lbfgs_eval":
        solve, solver = lbfgs_solve, LBFGSConfig(error_threshold=1e-9, iterations=4, line_search_iterations=20,
                                                 history=3)
    else:
        solve = bfgs_solve
    out = solve(error, vec, solver, value_and_grad_fn=value_grad, **kwargs)
    flat_out = solve(flat_error, flat, solver, value_and_grad_fn=flat_value_grad, **flat_kwargs)
    assert out.shape == vec.shape
    assert not torch.equal(out, vec)
    assert torch.equal(out.reshape(flat.shape).detach(), flat_out.detach())


@pytest.fixture(scope="module")
def scenes():
    """8 scenes of 3 views x 5 points drawn by the JAX package, float64."""
    return jax.jit(lambda k: j_generate_batch(k, B, JSceneConfig(num_views=M, num_points=N, dtype=jnp.float64)))(
        jax.random.key(21))


def _torch_batch(scenes):
    return CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in scenes))


def _to64(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


@pytest.mark.parametrize("head", ["mlp", "transformer", "fixed"])
def test_guess_heads_match_jax(head, scenes):
    pts, vis = scenes.projected_points, scenes.visibility_mask
    if head == "mlp":
        j_head, t_head = jm.PinholeMLPGuess(M, N, num_hidden=16), tm.PinholeMLPGuess(M, N, 16)
    elif head == "transformer":
        j_head = jm.PinholeTransformerGuess(M, N, num_estimates=3, embed_dim=16, num_layers=2, num_heads=4)
        # the JAX head's fixed pixel embedding, from jax.random.key(0)
        projection = jnp.linalg.qr(jax.random.normal(jax.random.key(0), (16, 16)))[0][:, :2]
        t_head = tm.PinholeTransformerGuess(M, N, num_estimates=3, embed_dim=16, num_layers=2, num_heads=4,
                                            pixel_projection=torch.tensor(np.asarray(projection, np.float64)))
    else:
        j_head, t_head = jm.PinholeFixedGuess(M, N), tm.PinholeFixedGuess(M, N)
    variables = _to64(jax.jit(j_head.init)(jax.random.key(5), pts, vis))
    if head == "fixed":  # move the learnable constants off their initial values
        variables = jax.tree_util.tree_map(lambda x: x + 0.1 * jnp.arange(x.size).reshape(x.shape), variables)
    t_head = t_head.double()
    tm.load_flax_tree(t_head, variables["params"], variables.get("batch_stats"))
    batch = _torch_batch(scenes)
    # only the MLP head's forward differs in training (its BatchNorm)
    for training in (False, True) if head == "mlp" else (False,):
        if training:
            j_out, mutated = jax.jit(lambda v, p, m: j_head.apply(v, p, m, training=True, mutable=["batch_stats"]))(
                variables, pts, vis)
        else:
            j_out = jax.jit(lambda v, p, m: j_head.apply(v, p, m, training=training))(variables, pts, vis)
            mutated = None
        t_out = t_head(batch.projected_points, batch.visibility_mask, training=training)
        for name, a, b in zip(t_out._fields, t_out, j_out):
            assert a.shape == b.shape, name
            _close(a, b, 1e-12, f"{head} training={training} {name}")
        if mutated is not None:
            stats = tm.gen1_to_flax(t_head.state_dict())[1]
            for key, value in _flat(mutated["batch_stats"]).items():
                _close(_flat(stats)[key], value, 1e-12, f"batch_stats {key}")
    params, stats = tm.gen1_to_flax(t_head.state_dict(), num_heads=4 if head == "transformer" else None)
    assert _flat(params).keys() == _flat(variables["params"]).keys()


@pytest.mark.parametrize("uniform", [False, True], ids=["he_normal", "he_uniform"])
def test_kaiming_init_matches_flax_statistics(uniform):
    """``dense_kaiming``'s weights against flax's ``he_normal`` /
    ``he_uniform`` on a (256, 512) kernel: the same support (two
    truncated standard deviations; the uniform's limit) and standard
    deviation within 3 %, the bias zero."""
    layer = tm.dense_kaiming(256, 512, uniform=uniform, generator=torch.Generator().manual_seed(0))
    init = jax.nn.initializers.he_uniform() if uniform else jax.nn.initializers.he_normal()
    theirs = np.asarray(init(jax.random.key(0), (256, 512), jnp.float64))
    ours = layer.weight.detach().double().numpy().T
    assert ours.shape == theirs.shape and torch.all(layer.bias == 0.0)
    assert abs(ours.std() / theirs.std() - 1.0) < 0.03
    assert np.abs(ours).max() <= np.abs(theirs).max() * 1.02 + 1e-12
    assert np.abs(ours).max() >= np.abs(theirs).max() * 0.95
