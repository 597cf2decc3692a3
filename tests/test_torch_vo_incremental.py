"""Learned incremental VO (``train/vo_eval.py``, the incremental pipeline):
the port against the JAX package on the same inputs, in float64.

``jax.random`` and torch's generators give different numbers, so the
sequence and its render are fed the JAX package's own draws (the key tree
of ``generate_trajectory`` and ``render_trajectory_images`` re-walked).
The accumulator is chaotic with respect to arithmetic (a 1e-15 difference
can flip a greedy association or an LM acceptance), so each stage is held
on fixed, well-conditioned inputs, as the JAX package's own tests do:
clean detections plus junk, truth bootstraps, a tiny converted guess
network.  Poses are compared as rotation matrices and translations (an
axis-angle of pi may come out with either sign).

Tolerances: generation and rendering 1e-12 / 1e-10, triangulation 1e-10,
PnP 1e-8 (its Jacobian is analytic in the port, ``jax.jacfwd`` in JAX),
the accumulator's poses 1e-8, its cost 1e-8 relative, the track table
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.camera import CalibrationParameters as JCalibrationParameters
from davo_tpu.camera import pack_calibration_parameters as j_pack
from davo_tpu.data.rendering import RenderConfig as JRenderConfig
from davo_tpu.geometry import so3_rotation_matrix as j_rotation
from davo_tpu.train import vo_eval as J
from davo_tpu_torch import cli
from davo_tpu_torch.data import RenderConfig
from davo_tpu_torch.geometry import so3_rotation_matrix
from davo_tpu_torch.train import vo_eval as T
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401


def _t(x, dtype=torch.float64):
    x = np.asarray(x)
    return torch.tensor(x) if x.dtype == bool else torch.tensor(x, dtype=dtype)


def _jax_trajectory_draws(key, cfg):
    """The unit draws of ``generate_trajectory``, key for key."""
    k_pts, k_noise = jax.random.split(key)
    n, kf = cfg.num_points, cfg.num_frames
    draws = dict(
        xy=jax.random.normal(k_pts, (n, 2)),
        z=jax.random.normal(jax.random.fold_in(k_pts, 1), (n, 1)),
    )
    if cfg.pixel_noise > 0.0:
        draws["pixels"] = jax.random.normal(k_noise, (kf, n, 2))
    return {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}


def _jax_render_draws(key, kf, n, cfg):
    """The unit draws of ``render_trajectory_images``, key for key."""
    dt, cells, s, c = cfg.dtype, cfg.background_cells, cfg.image_size, cfg.channels
    k_app, k_noise = jax.random.split(key)
    k_col, k_scale, k_theta, k_ecc, k_freq, k_phase = jax.random.split(k_app, 6)
    appearance = dict(
        colour=jax.random.uniform(k_col, (n, 3), dt),
        log_scale=jax.random.normal(k_scale, (n, 1), dt),
        theta=jax.random.uniform(k_theta, (n, 1), dt),
        ecc=jax.random.uniform(k_ecc, (n, 1), dt),
        freq=jax.random.uniform(k_freq, (n, 1), dt),
        phase=jax.random.uniform(k_phase, (n, 1), dt),
    )

    def frame(kf_):
        k_bg, k_px = jax.random.split(kf_)
        return dict(background=jax.random.uniform(k_bg, (cells, cells, c), dt),
                    pixels=jax.random.normal(k_px, (s, s, c), dt))

    frames = jax.vmap(frame)(jax.random.split(k_noise, kf))
    convert = lambda d: {k: torch.tensor(np.asarray(v)) for k, v in d.items()}  # noqa: E731
    return dict(appearance=convert(appearance), frame=convert(frames))


def _port_config(j_cfg):
    return T.TrajectoryConfig(**{f.name: getattr(j_cfg, f.name) for f in dataclasses.fields(J.TrajectoryConfig)
                                 if f.name != "solver"}, dtype=torch.float64)


def _sequence(seed, **overrides):
    j_cfg = J.TrajectoryConfig(**overrides)
    key = jax.random.key(seed)
    expected = J.generate_trajectory(key, j_cfg)
    got = T.trajectory_from_noise(_jax_trajectory_draws(key, j_cfg), _port_config(j_cfg))
    return j_cfg, expected, got


def _assert_poses_close(got, expected, tol):
    got, expected = _t(to_numpy(got)), _t(np.asarray(expected))
    np.testing.assert_allclose(to_numpy(so3_rotation_matrix(got[:, :3])), to_numpy(so3_rotation_matrix(expected[:, :3])),
                               rtol=0, atol=tol)
    scale = max(1.0, float(expected[:, 3:].abs().max()))
    np.testing.assert_allclose(to_numpy(got[:, 3:]), to_numpy(expected[:, 3:]), rtol=0, atol=tol * scale)


def _ate(est, poses):
    est, poses = _t(to_numpy(est)), _t(np.asarray(poses))
    centres = T.camera_centers_from_poses(est[:, :3], est[:, 3:])
    return float(T.absolute_trajectory_error(centres, T.camera_centers_from_poses(poses[:, :3], poses[:, 3:]))["rmse"])


# ------------------------------------------------------- generation ----


@pytest.mark.parametrize("overrides", [{}, dict(num_frames=12, num_points=8, pixel_noise=0.01)],
                         ids=["defaults", "noisy"])
def test_generate_trajectory_from_jax_draws(overrides):
    _, expected, got = _sequence(4, **overrides)
    for name, e, g in zip(("poses", "points", "pixels", "visibility"), expected, got):
        if name == "visibility":
            np.testing.assert_array_equal(to_numpy(g), np.asarray(e))
        else:
            np.testing.assert_allclose(to_numpy(g), np.asarray(e), rtol=0, atol=1e-12, err_msg=name)


def test_generate_trajectory_draws_from_a_torch_generator():
    cfg = T.TrajectoryConfig(num_frames=6, num_points=5)
    a = T.generate_trajectory(torch.Generator().manual_seed(1), cfg, device="cpu")
    b = T.generate_trajectory(torch.Generator().manual_seed(1), cfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (6, 6) and a[2].shape == (6, 5, 2) and a[0].dtype == torch.float32


def test_render_trajectory_images_from_jax_draws():
    j_cfg, (_, _, pixels, vis), _ = _sequence(5, num_frames=5, num_points=6)
    j_render = JRenderConfig(image_size=24, dtype=jnp.float64)
    key = jax.random.key(9)
    expected = J.render_trajectory_images(pixels, vis, key, j_render)
    got = T.render_trajectory_images(
        _t(pixels), _t(vis), render_config=RenderConfig(image_size=24, dtype=torch.float64),
        noise=_jax_render_draws(key, 5, 6, j_render),
    )
    assert got.shape == (5, 24, 24, 3)
    np.testing.assert_allclose(to_numpy(got), np.asarray(expected), rtol=0, atol=1e-10)


# --------------------------------------------------------- geometry ----


def test_triangulate_points_matches_jax():
    j_cfg, (poses, points, pixels, vis), _ = _sequence(6, num_frames=8, num_points=12)
    intr = np.array([j_cfg.focal_length, 0.0, 0.0])
    vis = np.asarray(vis).copy()
    vis[:, 0] = False  # a point no view sees: the LU's answer on both sides
    got = T.triangulate_points(_t(poses), _t(intr), _t(pixels), _t(vis))
    expected = J.triangulate_points(poses, jnp.asarray(intr), pixels, jnp.asarray(vis))
    np.testing.assert_allclose(to_numpy(got)[1:], np.asarray(expected)[1:], rtol=0, atol=1e-10)
    seen = vis.sum(axis=0) >= 2
    np.testing.assert_allclose(to_numpy(got)[seen], np.asarray(points)[seen], rtol=0, atol=1e-6)


@pytest.mark.parametrize("huber", [False, True], ids=["plain", "huber_outliers"])
def test_pnp_pose_matches_jax(huber):
    j_cfg, (poses, points, pixels, vis), _ = _sequence(7, num_frames=6, num_points=16)
    intr = jnp.asarray([j_cfg.focal_length, 0.0, 0.0])
    k = 3
    pix = np.asarray(pixels[k]).copy()
    if huber:
        pix[0] += [0.6, -0.4]
        pix[5] += [-0.5, 0.3]
    init = np.asarray(poses[k]) + 0.05 * np.random.default_rng(0).normal(size=6)
    w = np.asarray(vis[k], np.float64)
    rounds = 3 if huber else 2
    expected = J.pnp_pose(points, jnp.asarray(pix), jnp.asarray(w), intr, jnp.asarray(init), huber_rounds=rounds)
    got = T.pnp_pose(_t(points), _t(pix), _t(w), _t(intr), _t(init), huber_rounds=rounds)
    np.testing.assert_allclose(to_numpy(got), np.asarray(expected), rtol=0, atol=1e-8)
    if not huber:
        assert float(np.max(np.abs(to_numpy(got) - np.asarray(poses[k])))) < 1e-4


def test_pnp_pose_batched_over_weights_matches_jax():
    """The RANSAC candidates' batch (``_pnp_batch_jit``): one frame, the
    full set and random subsets, and an all-zero row (the NaN guard)."""
    j_cfg, (poses, points, pixels, vis), _ = _sequence(8, num_frames=6, num_points=12)
    intr = jnp.asarray([j_cfg.focal_length, 0.0, 0.0])
    rng = np.random.default_rng(1)
    w = np.stack([np.asarray(vis[2], np.float64)] + [(rng.random(12) > 0.5) * 1.0 for _ in range(4)] + [np.zeros(12)])
    init = np.asarray(poses[2]) + 0.03 * rng.normal(size=6)
    expected = J._pnp_batch_jit(points, pixels[2], jnp.asarray(w), intr, jnp.asarray(init))
    got = T.pnp_pose(_t(points), _t(pixels[2]), _t(w), _t(intr), _t(init))
    assert got.shape == (6, 6)
    np.testing.assert_allclose(to_numpy(got), np.asarray(expected), rtol=0, atol=1e-8)
    assert np.all(np.isfinite(to_numpy(got)))


def test_associate_detections_matches_jax():
    rng = np.random.default_rng(2)
    for trial in range(20):
        n, d = 8, 15
        proj = rng.uniform(-1, 1, size=(n, 2))
        dets = np.concatenate([proj[: n // 2] + 0.03 * rng.normal(size=(n // 2, 2)), rng.uniform(-1, 1, size=(d - n // 2, 2))])
        active, ok = rng.random(n) > 0.2, rng.random(d) > 0.2
        desc = rng.uniform(0, 0.1, size=(n, d)) if trial % 2 else None
        expected = J._associate_detections(proj.copy(), active, dets, ok, 0.12, None if desc is None else desc.copy())
        got = T._associate_detections(proj.copy(), active, dets, ok, 0.12, None if desc is None else desc.copy())
        for e, g in zip(expected, got):
            np.testing.assert_array_equal(g, e)


def test_refine_trajectory_global_matches_jax_and_refuses_a_mesh():
    j_cfg, (poses, _, pixels, vis), _ = _sequence(16, num_frames=6, num_points=10)
    intr = jnp.asarray([j_cfg.focal_length, 0.0, 0.0])
    noisy = np.asarray(poses) + np.concatenate([np.zeros((1, 6)), 0.01 * np.random.default_rng(4).normal(size=(5, 6))])
    expected = J.refine_trajectory_global(jnp.asarray(noisy), intr, pixels, vis, rounds=2)
    got = T.refine_trajectory_global(_t(noisy), _t(intr), _t(pixels), _t(vis), rounds=2)
    _assert_poses_close(got, expected, 1e-8)
    # a mesh is taken (at 4 ranks in test_torch_parallel.py); what is not a
    # DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        T.refine_trajectory_global(_t(noisy), _t(intr), _t(pixels), _t(vis), mesh=object())


# -------------------------------------------------------------- CLI ----


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """A pickle of a tiny transformer head's random weights, in the JAX
    package's numpy format."""
    import pickle

    from davo_tpu_torch.models import state_dict_to_flax
    from davo_tpu_torch.train import get_preset

    cfg = dataclasses.replace(get_preset("calibration_transformer_curriculum"), num_views=4, num_points=8,
                              hidden_size=16, transformer_layers=1, transformer_heads=2)
    net = cfg.build_network("cpu", generator=torch.Generator().manual_seed(0))
    params, stats = state_dict_to_flax(net.state_dict(), num_heads=2)
    path = tmp_path_factory.mktemp("vo") / "tiny.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batch_stats": stats}, f)
    return str(path)


def _tiny_args(checkpoint, *extra):
    return ["vo-eval", "--platform", "cpu", "--checkpoint", checkpoint, "--hidden-size", "16",
            "--transformer-layers", "1", "--transformer-heads", "2", "--frames", "5", "--restarts", "1",
            "--trials", "2", "--pipeline", "incremental", *extra]


def test_cli_vo_eval_prints_a_line_a_trial_and_the_mean(tiny_checkpoint, capsys):
    result = cli.main(_tiny_args(tiny_checkpoint, "--no-refine", "--num-bootstraps", "1"))
    assert result == 0
    import json

    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert [line.get("trial") for line in lines[:2]] == [0, 1]
    assert set(lines[0]) == {"trial", "rmse", "mean", "median", "max"}
    assert set(lines[-1]) == {"mean_ate_rmse"}
    mean = (lines[0]["rmse"] + lines[1]["rmse"]) / 2
    assert lines[-1]["mean_ate_rmse"] == pytest.approx(mean, rel=1e-5)


def test_cli_vo_eval_descriptor_association_on_two_anchored_tracks(tiny_checkpoint, capsys):
    """--matches learned --association descriptor --track-anchors 2: the
    front end's whole-sequence tracks from both ends (16 tracks) feed the
    oracle-track accumulator; the bootstrap window is matched fresh."""
    import json

    args = _tiny_args(tiny_checkpoint, "--no-refine", "--num-bootstraps", "1", "--matches", "learned",
                      "--association", "descriptor", "--track-anchors", "2", "--frontend-checkpoint",
                      "davo_tpu_torch/weights/frontend_v4.npz", "--image-size", "32")
    args[args.index("--trials") + 1] = "1"
    assert cli.main(args) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines[0]["trial"] == 0 and np.isfinite(lines[0]["rmse"]) and set(lines[-1]) == {"mean_ate_rmse"}


@pytest.mark.parametrize(
    "extra,match",
    [
        (("--matches", "learned", "--frontend-checkpoint", "artifacts/ckpt_frontend_v4"), "item 8"),
    ],
    ids=["orbax_frontend"],
)
def test_cli_vo_eval_refuses_what_is_not_ported(tiny_checkpoint, extra, match):
    args = _tiny_args(tiny_checkpoint, "--trials", "1")
    with pytest.raises(NotImplementedError, match=match):
        cli.run(args + list(extra))


def test_cli_vo_eval_needs_the_card_unless_asked_for_the_cpu(tiny_checkpoint):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = _tiny_args(tiny_checkpoint)
    args.remove("--platform")
    args.remove("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.run(args)
