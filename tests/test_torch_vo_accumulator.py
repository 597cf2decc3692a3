"""The incremental-VO accumulator: the port against the JAX package on
fixed, well-conditioned inputs, in float64 (its learned bootstrap:
``test_torch_vo_learned.py``).

The accumulator is chaotic with respect to arithmetic (a 1e-15
difference can flip a greedy association or an LM acceptance), so it is
held on the inputs the JAX package's own tests use: oracle detections
among junk blobs, truth bootstraps, and a tiny converted guess network
whose output layer carries the truth vector (its weights scaled to 1e-3,
so the guess is the truth moved by what every layer computes).  The cases
share one sequence shape (6 frames of 8 points, 12 detections a frame),
so the JAX package compiles its solvers once for the file, apart from the
geometric detection case, which is the JAX test's own (10 frames, its
key) so that the chain it holds is a healthy one.

Tolerances: poses 1e-8 (rotation matrices, and translations relative to
their scale), the track table and visibility exactly, intrinsics 1e-8,
costs 1e-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vo_incremental import (
    J,
    T,
    _assert_poses_close,
    _ate,
    _sequence,
    _t,
)
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

FRAMES, POINTS = 6, 8
# the JAX test test_detection_pipeline_robust_options: 10 frames, and its
# key (tests/conftest.py's seed for that test's name)
ROBUST_FRAMES, ROBUST_SEED = 10, 211328452


def _clean_detections(pixels, vis, num_dets=12, seed=7):
    """Oracle projections among junk blobs, shuffled (the JAX test's)."""
    rng = np.random.default_rng(seed)
    pix, visn = np.asarray(pixels), np.asarray(vis)
    kf, n = pix.shape[0], pix.shape[1]
    dets = 0.95 * (2.0 * rng.random((kf, num_dets, 2)) - 1.0)
    scores = np.full((kf, num_dets), 0.4)
    for k in range(kf):
        order = rng.permutation(num_dets)[:n]
        dets[k, order] = pix[k]
        scores[k, order] = np.where(visn[k], 0.9, 0.0)
    return dets, scores


def _truth_vector(poses, points, cfg, start=0):
    """The gen-2 calibration vector of the window at ``start`` (the JAX
    test's truth-vector guess)."""
    from davo_tpu.camera import CalibrationParameters, pack_calibration_parameters
    from davo_tpu.geometry import so3_rotation_matrix

    w = cfg.window
    rel = J._to_window_frame(poses[start: start + w], poses[start])
    f = cfg.focal_length
    pts = jnp.einsum("ij,nj->ni", so3_rotation_matrix(poses[start, 0:3]), points) + poses[start, 3:6]
    return pack_calibration_parameters(CalibrationParameters(
        intrinsics=jnp.asarray([f - 1.0 if f >= 1.0 else np.log(f), 0.0, 0.0]).reshape(1, 1, 3),
        world_points=pts.reshape(1, -1, 3),
        camera_translations=rel[1:, 3:6].reshape(w - 1, 1, 3),
        camera_rotations=rel[1:, 0:3].reshape(w - 1, 1, 3),
    ))


def _truth_guesses(poses, points, pixels, cfg):
    """JAX and port guess functions returning the truth vector of the
    window whose oracle pixels they are handed."""
    starts = range(cfg.num_frames - cfg.window + 1)
    vectors = {s: np.asarray(_truth_vector(poses, points, cfg, s)) for s in starts}
    windows = {s: np.asarray(pixels)[s: s + cfg.window] for s in starts}

    def start_of(w_pix):
        w_pix = np.asarray(w_pix)[0]
        return next(s for s, w in windows.items() if np.array_equal(w, w_pix))

    return (lambda pw, vw: jnp.asarray(vectors[start_of(pw)])[None]), \
        (lambda pw, vw: _t(vectors[start_of(pw.numpy())])[None])


def _tiny_networks(monkeypatch, head_bias):
    """The JAX package's transformer-head CalibrationNetwork at a tiny
    width (flax init, float64; the output layer's kernel scaled to 1e-3
    and its bias ``head_bias``) and the port's network with its weights.
    One start, 8 BFGS iterations; the JAX side's fused objective is its
    Pallas kernel's function (polynomial atan2), which the port's K2
    computes."""
    import davo_tpu.models.calibration_network as j_network_module
    from davo_tpu.models import CalibrationNetwork as JNetwork
    from davo_tpu.solve import BFGSConfig as JBFGSConfig
    from davo_tpu_torch.models import CalibrationNetwork, load_flax_weights
    from davo_tpu_torch.solve import BFGSConfig
    from tests.test_torch_calibration_network import _kernel_function_objective

    monkeypatch.setattr(j_network_module, "make_fused_calibration_objective", _kernel_function_objective)
    solver = dict(error_threshold=1e-7, iterations=8, line_search_iterations=20)
    arch = dict(num_views=4, num_points=POINTS, hidden_size=16, head="transformer", transformer_layers=1,
                transformer_heads=2, num_restarts=1)
    j_net = JNetwork(solver=JBFGSConfig(**solver), fused_objective=True, **arch)
    variables = j_net.init(jax.random.key(0), jnp.zeros((1, 4, POINTS, 2)), jnp.ones((1, 4, POINTS)))
    variables = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), variables)
    head = variables["params"]["initial_estimator"]["head"]
    head["kernel"] = 1e-3 * head["kernel"]
    head["bias"] = np.asarray(head_bias, np.float64)
    net = CalibrationNetwork(solver=BFGSConfig(**solver), device="cpu", dtype=torch.float64, **arch)
    load_flax_weights(net, variables["params"], variables.get("batch_stats", {}))
    j_apply = jax.jit(lambda pw, vw: j_net.apply(variables, pw, vw))
    return j_apply, (lambda pw, vw: net(pw, vw))


def _case(seed, frames=FRAMES):
    j_cfg, (poses, points, pixels, vis), _ = _sequence(seed, num_frames=frames, num_points=POINTS)
    return j_cfg, poses, points, pixels, vis


def test_solve_incremental_vo_matches_jax():
    """Oracle tracks with sparse visibility (the descriptor-association
    branch's accumulator), a 3-frame truth bootstrap."""
    j_cfg, poses, _, pixels, vis = _case(11)
    intr = jnp.asarray([j_cfg.focal_length, 0.0, 0.0])
    boot = J._to_window_frame(poses[:3], poses[0])
    drop = np.random.default_rng(3).random(np.shape(vis)) < 0.2
    drop[0] = False
    vis = np.asarray(vis) & ~drop
    expected = J.solve_incremental_vo(pixels, jnp.asarray(vis), intr, boot, ba_every=2)
    got = T.solve_incremental_vo(_t(pixels), _t(vis), _t(intr), _t(boot), ba_every=2)
    _assert_poses_close(got, expected, 1e-8)
    assert _ate(got, poses) < 1e-3


@pytest.mark.parametrize("descriptors", [False, True], ids=["geometric", "with_descriptor_identity"])
def test_solve_incremental_vo_detections_matches_jax(descriptors):
    """Clean detections plus junk, every robustness option on (ba_irls,
    pnp_ransac, chain_passes 2, reject_outliers), a bootstrap at frame 0
    (geometric, the true focal: the JAX test's case, 10 frames) or at
    frame 1 (the chain runs backward too; a focal 5 % off, which
    refine_intrinsics frees; 6 frames); with the descriptor identity,
    descriptors that identify each true point (junk random): poses, track
    table, intrinsics and the coverage-penalised cost agree, and both
    chains are healthy (ATE and cost below the JAX test's 5e-3)."""
    if descriptors:
        j_cfg, poses, _, pixels, vis = _case(12)
    else:
        j_cfg, poses, _, pixels, vis = _case(ROBUST_SEED, ROBUST_FRAMES)
    intr = jnp.asarray([j_cfg.focal_length * (1.05 if descriptors else 1.0), 0.0, 0.0])
    s0 = 1 if descriptors else 0
    boot = J._to_window_frame(poses[s0: s0 + 2], poses[s0])
    dets, scores = _clean_detections(pixels, vis)
    kw = dict(ba_irls=1, pnp_ransac=4, chain_passes=2, reject_outliers=True, return_cost=True,
              refine_intrinsics=descriptors, bootstrap_start=s0)
    boot_tracks, boot_vis = np.asarray(pixels[s0: s0 + 2]), np.asarray(vis[s0: s0 + 2], np.float64)
    j_kw, t_kw = dict(kw), dict(kw)
    if descriptors:
        rng = np.random.default_rng(5)
        identity = rng.normal(size=(POINTS, 6))
        desc = rng.normal(size=dets.shape[:2] + (6,))
        for k in range(dets.shape[0]):
            for i in range(POINTS):
                desc[k, int(np.argmin(np.linalg.norm(dets[k] - np.asarray(pixels)[k, i], axis=-1)))] = identity[i]
        j_kw.update(det_descriptors=jnp.asarray(desc), desc_weight=0.05)
        t_kw.update(det_descriptors=_t(desc), desc_weight=0.05)
    j_debug, t_debug = {}, {}
    est_j, cost_j = J.solve_incremental_vo_detections(
        jnp.asarray(dets), jnp.asarray(scores), intr, boot, jnp.asarray(boot_tracks), jnp.asarray(boot_vis),
        debug_out=j_debug, **j_kw)
    est_t, cost_t = T.solve_incremental_vo_detections(
        _t(dets), _t(scores), _t(intr), _t(boot), _t(boot_tracks), _t(boot_vis), debug_out=t_debug, **t_kw)
    _assert_poses_close(est_t, est_j, 1e-8)
    np.testing.assert_array_equal(t_debug["vis"], j_debug["vis"])
    np.testing.assert_array_equal(t_debug["tracks"], j_debug["tracks"])
    np.testing.assert_allclose(t_debug["intrinsics"], np.asarray(j_debug["intrinsics"]), rtol=0, atol=1e-8)
    assert abs(cost_t - float(cost_j)) <= 1e-8 * max(1.0, abs(float(cost_j)))
    assert _ate(est_t, poses) < 5e-3 and cost_t < 5e-3
