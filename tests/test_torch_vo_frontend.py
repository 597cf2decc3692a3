"""The visual front end with its trained weights: the port's ``VOFrontend``
against the JAX package's, float64, on two windows rendered by the JAX
package at 96 px.

The weights are ``davo_tpu_torch/weights/frontend_v4.npz`` (equal to the
Orbax checkpoint ``artifacts/ckpt_frontend_v4``, see
``test_torch_frontend_weights.py``), cast to float64 on both sides.  Each
gate setting of the JAX module is run: all off; snap with cycle
consistency, score threshold and quality bonus; the soft-gate floor; the
confidence gate; greedy NMS with centroid refinement.  ``points``,
``scores`` and ``matched`` agree to 1e-9; the selected ``matches`` agree to
1e-9 and ``match_visibility`` is identical.  On the CPU the port's matcher
runs K3's plain version and the JAX package its jnp attention, which agree
on unmasked keys.  The eval metrics (losses, ``match_inlier_rate``) agree
to 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.data import VOWindowConfig as JWindowConfig
from davo_tpu.data import generate_vo_window_batch as j_generate_vo_window_batch
from davo_tpu.data.rendering import RenderConfig as JRenderConfig
from davo_tpu.models.vo_frontend import VOFrontend as JVOFrontend
from davo_tpu.train.frontend import FrontendExperiment as JFrontendExperiment
from davo_tpu.train.frontend import frontend_loss as j_frontend_loss
from davo_tpu.train.frontend import render_scene_batch as j_render_scene_batch
from davo_tpu_torch.models import FRONTEND_V4, load_frontend, load_frontend_npz
from davo_tpu_torch.train import FrontendExperiment, frontend_eval_metrics
from davo_tpu_torch.types import CameraViewsAndPoints
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

TOL = 1e-9
GATES = {
    "off": {},
    "snap_cycle_score": dict(snap_radius=0.12, cycle_threshold=0.15, score_threshold=0.2, quality_bonus=10.0),
    "soft_floor": dict(snap_radius=0.05, soft_gate_floor=0.3),
    "confidence": dict(match_confidence_threshold=0.9),
    "nms_refine": dict(nms_radius=0.1, centroid_refine_iters=2),
}


@pytest.fixture(scope="module")
def windows_and_images():
    """Two JAX windows (seed 0) rendered at the front end's 96 px."""
    key = jax.random.key(0)
    windows = j_generate_vo_window_batch(key, 2, JWindowConfig(dtype=jnp.float64))
    images = j_render_scene_batch(jax.random.fold_in(key, 1), windows, JRenderConfig(image_size=96, dtype=jnp.float64))
    return windows, np.asarray(images)


@pytest.fixture(scope="module")
def jax_variables():
    tree = load_frontend_npz(FRONTEND_V4)
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), tree)


def _run_both(gates, images, variables):
    j_out = JVOFrontend(**gates).apply(variables, jnp.asarray(images))
    frontend, render = load_frontend(device="cpu", dtype=torch.float64, **gates)
    assert render.image_size == 96 and frontend.num_select == 8
    return j_out, frontend(torch.tensor(images))


@pytest.mark.parametrize("gates", list(GATES.values()), ids=list(GATES))
def test_frontend_matches_jax(gates, windows_and_images, jax_variables):
    _, images = windows_and_images
    j_out, out = _run_both(gates, images, jax_variables)
    assert out.matches.shape == (2, 4, 8, 2)
    for name in ("points", "scores", "matched", "matches"):
        np.testing.assert_allclose(
            to_numpy(getattr(out, name)), np.asarray(getattr(j_out, name)), rtol=TOL, atol=TOL, err_msg=name
        )
    np.testing.assert_array_equal(to_numpy(out.match_visibility), np.asarray(j_out.match_visibility))
    if gates and "nms_radius" not in gates:  # the gate acted on these windows
        assert not bool(torch.all(out.match_visibility == 1))
    if "match_confidence_threshold" in gates:
        np.testing.assert_allclose(to_numpy(out.confidence), np.asarray(j_out.confidence), rtol=TOL, atol=TOL)
    else:
        assert out.confidence is None


def test_eval_metrics_match_jax(windows_and_images, jax_variables):
    windows, images = windows_and_images
    j_out, out = _run_both({}, images, jax_variables)
    j_exp = JFrontendExperiment(image_size=96)
    _, j_metrics = j_frontend_loss(j_out, windows, j_exp)
    batch = CameraViewsAndPoints(*(torch.tensor(np.asarray(x)) for x in windows))
    metrics = frontend_eval_metrics(out, batch, FrontendExperiment())
    for name, value in j_metrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), rtol=TOL, atol=TOL, err_msg=name)
    # the JAX eval_step's inlier rate, computed here as it does
    proj = np.asarray(windows.projected_points)
    vis = np.asarray(windows.visibility_mask)
    d2 = np.sum(np.square(np.asarray(j_out.matches)[:, :, :, None] - proj[:, :, None]), axis=-1)
    near = np.sqrt(np.min(np.where(vis[:, :, None, :], d2, np.inf), axis=-1))
    mvis = np.asarray(j_out.match_visibility, np.float64)
    expected_rate = np.sum((near < 0.09) * mvis) / max(np.sum(mvis), 1.0)
    np.testing.assert_allclose(float(metrics["match_inlier_rate"]), expected_rate, rtol=TOL, atol=TOL)
    assert float(metrics["match_inlier_rate"]) > 0.8  # the trained weights match


def test_track_sequence_is_refused():
    frontend, _ = load_frontend(device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        frontend(torch.zeros(1, 2, 96, 96, 3), track_sequence=True)


def test_nfold_matcher_matches_jax():
    from davo_tpu.models.matcher import NFoldMatcherModule as JNFoldMatcher
    from davo_tpu.types import FeaturePoints as JFeaturePoints
    from davo_tpu_torch.models import NFoldMatcherModule
    from davo_tpu_torch.types import FeaturePoints

    matcher = load_frontend_npz(FRONTEND_V4)["params"]["matcher"]
    rng = np.random.default_rng(3)
    feats = [(rng.uniform(-1, 1, size=(2, 30, 2)), rng.normal(size=(2, 30, 64))) for _ in range(3)]
    j_params = {"pairwise": jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64), matcher)}
    expected = JNFoldMatcher(descriptor_size=64, embedding_size=64).apply(
        {"params": j_params},
        JFeaturePoints(*(jnp.asarray(x) for x in feats[0])),
        [JFeaturePoints(*(jnp.asarray(x) for x in f)) for f in feats[1:]],
    )
    port = NFoldMatcherModule(64, 64).double().eval()
    port.load_state_dict({
        f"pairwise.{name}.{field}": torch.tensor(np.asarray(matcher[name][key], np.float64)).T.contiguous()
        if key == "kernel" else torch.tensor(np.asarray(matcher[name][key], np.float64))
        for name in ("query", "key") for field, key in (("weight", "kernel"), ("bias", "bias"))
    })
    got = port(FeaturePoints(*(torch.tensor(x) for x in feats[0])), [FeaturePoints(*(torch.tensor(x) for x in f)) for f in feats[1:]])
    assert len(got) == 2
    for g, e in zip(got, expected):
        np.testing.assert_allclose(to_numpy(g.points_b), np.asarray(e.points_b), rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(to_numpy(g.points_a), np.asarray(e.points_a))


def test_experiment_builds_the_served_architecture():
    frontend, _ = load_frontend(device="cpu")
    built = FrontendExperiment().build_network(device="cpu", snap_radius=0.1)
    assert built.snap_radius == 0.1 and not built.training
    assert {k: v.shape for k, v in built.state_dict().items()} == {k: v.shape for k, v in frontend.state_dict().items()}
