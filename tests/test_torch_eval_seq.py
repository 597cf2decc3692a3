"""VO along trajectory files (``train/vo_eval.py::observations_for_poses``,
``evaluate_vo_sequence_file``, ``cli eval-seq``): the port against the
JAX package in float64, with the JAX key's draws injected.

The files are ``tests/fixtures/*``: the same 12-frame trajectory in TUM
and KITTI form, and a TUM estimate of it.  The oracle path (chained
Schur windows from noisy priors) is held against the JAX package's (the
learned path in ``test_torch_eval_seq_learned.py``); ``cli eval-seq
--est`` prints the JAX CLI's JSON.

Tolerances: the synthesised observations 1e-12 (relative where a point
behind a camera projects through the depth clamp); the oracle path's ATE
and RPE 1e-7 (LM decisions on converged iterates); the compare mode's
JSON 1e-9.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu import cli as j_cli
from davo_tpu.data.sequences import load_sequence as j_load_sequence
from davo_tpu_torch import cli
from tests.test_torch_vo_incremental import J, T, _t
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
KITTI = os.path.join(FIXTURES, "kitti_mini_00.txt")
TUM = os.path.join(FIXTURES, "tum_mini_groundtruth.txt")
POINTS = 8


def _observation_draws(key, points, frames=None):
    """``observations_for_poses``'s draws, key for key (the unit uniform
    of its depths, the scatter's normals, and with ``frames`` the pixel
    noise)."""
    k_d, k_s = jax.random.split(key)
    draws = dict(depths=jax.random.uniform(k_d, (points, 1), jnp.float64),
                 scatter=jax.random.normal(k_s, (points, 3), jnp.float64))
    if frames:
        draws["pixels"] = jax.random.normal(jax.random.fold_in(key, 2), (frames, points, 2), jnp.float64)
    return {k: _t(np.asarray(v)) for k, v in draws.items()}


def _metrics_close(got, expected, tol):
    assert set(got) == set(expected)
    for name, value in expected.items():
        assert abs(float(got[name]) - float(value)) <= tol * max(1.0, abs(float(value))), name


@pytest.mark.parametrize("path,fmt,pixel_noise", [(KITTI, "kitti", 0.0), (TUM, "tum", 0.003)], ids=["kitti", "tum_noisy"])
def test_observations_for_poses_matches_jax(path, fmt, pixel_noise):
    poses = j_load_sequence(path, fmt).poses
    intrinsics = jnp.asarray([1.4, 0.05, -0.02])
    key = jax.random.key(41)
    expected = J.observations_for_poses(poses, intrinsics, key, num_points=24, pixel_noise=pixel_noise)
    got = T.observations_for_poses(_t(poses), _t(intrinsics), num_points=24, pixel_noise=pixel_noise,
                                   noise=_observation_draws(key, 24, 12 if pixel_noise else None))
    for name, g, e in zip(("points", "pixels"), got, expected):
        # points behind a camera project through the 1e-8 depth clamp to
        # pixels of 1e7: relative there
        np.testing.assert_allclose(to_numpy(g), np.asarray(e), rtol=1e-12, atol=1e-12, err_msg=name)
    np.testing.assert_array_equal(to_numpy(got[2]), np.asarray(expected[2]))
    assert np.asarray(expected[2]).any(axis=1).all()  # every frame sees landmarks


def _prior_draws(key, frames, points):
    k1, k2 = jax.random.split(key)
    return dict(poses=_t(np.asarray(jax.random.normal(k1, (frames - 1, 6)))),
                points=_t(np.asarray(jax.random.normal(k2, (points, 3)))))


# tests/data/test_sequences.py::test_evaluate_vo_sequence_file_end_to_end's
# key (tests/conftest.py's seed for that test's name) and solver
END_TO_END_SEED = 614030047


@pytest.mark.parametrize("path,fmt", [(KITTI, "kitti"), (TUM, "tum")], ids=["kitti", "tum"])
def test_oracle_sequence_file_matches_jax(path, fmt):
    """The oracle path along each file, as the JAX package's end-to-end
    test runs it (24 landmarks, windows of 4, 8 LM iterations): the ATE
    and RPE of the JAX package's, and that test's bounds."""
    key = jax.random.key(END_TO_END_SEED)
    config = J.TrajectoryConfig(window=4, solver=J.SchurConfig(iterations=8, damping=1e-4))
    expected = J.evaluate_vo_sequence_file(path, format=fmt, config=config, key=key, num_points=24)
    k_obs, k_solve = jax.random.split(key)
    got = T.evaluate_vo_sequence_file(
        path, format=fmt, num_points=24, device="cpu",
        config=T.TrajectoryConfig(window=4, solver=T.SchurConfig(iterations=8, damping=1e-4), dtype=torch.float64),
        noise=dict(observations=_observation_draws(k_obs, 24), priors=_prior_draws(k_solve, 12, 24)),
    )
    _metrics_close(got, expected, 1e-7)
    assert int(got["num_frames"]) == 12 and float(got["rmse"]) < 0.05 and float(got["rpe_trans_rmse"]) < 0.1


def _rotated_estimate(tmp_path):
    """The TUM estimate with each quaternion moved by 0.02 times a normal
    (numpy's default_rng(5)): its orientations equal the ground truth's,
    where the RPE's rotation is arccos(1 - rounding), noise of 1e-8."""
    rows = [line.split() for line in open(os.path.join(FIXTURES, "tum_mini_estimated.txt"))
            if line.strip() and not line.startswith("#")]
    rng = np.random.default_rng(5)
    lines = []
    for row in rows:
        q = np.asarray(row[4:8], float) + 0.02 * rng.standard_normal(4)
        lines.append(" ".join(row[:4] + [f"{x:.9f}" for x in q / np.linalg.norm(q)]))
    path = tmp_path / "rotated.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("delta", ["1", "2"])
def test_cli_eval_seq_compare_mode_prints_the_jax_json(tmp_path, capsys, delta):
    """``eval-seq --est``: a rotated TUM estimate against its ground truth,
    pairs associated by timestamp; the JSON of the JAX CLI (x64, as the
    tests run it), key for key."""
    args = ["eval-seq", "--gt", TUM, "--est", _rotated_estimate(tmp_path), "--platform", "cpu", "--rpe-delta", delta]
    assert j_cli.main(args) == 0
    expected = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    _metrics_close(got, expected, 1e-9)
    assert got["pairs"] == 12.0 and got["rpe_rot_rmse"] > 1e-3


def test_cli_eval_seq_compare_mode_needs_associated_pairs():
    with pytest.raises(ValueError, match="no associated timestamp pairs"):
        cli.run(["eval-seq", "--gt", TUM, "--est", os.path.join(FIXTURES, "tum_mini_estimated.txt"), "--platform",
                 "cpu", "--max-dt", "-1"])


@pytest.mark.parametrize("extra", [(), ("--calib", os.path.join(FIXTURES, "kitti_mini_calib.txt"))],
                         ids=["default_focal", "calib"])
def test_cli_eval_seq_oracle_mode(extra, capsys):
    """VO along the KITTI file on the CPU: the JAX CLI's output keys and
    finite figures."""
    assert cli.main(["eval-seq", "--gt", KITTI, "--format", "kitti", "--platform", "cpu", "--points", "16", *extra]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == {"rmse", "mean", "median", "max", "rpe_trans_rmse", "rpe_trans_mean", "rpe_rot_rmse",
                        "rpe_rot_mean", "num_frames"}
    assert got["num_frames"] == 12.0 and all(np.isfinite(v) for v in got.values())


def test_cli_eval_seq_learned_mode(tmp_path, capsys, monkeypatch):
    """``eval-seq --checkpoint`` (a tiny head's pickle) on the CPU: the
    windows pipeline runs; the incremental one hands the synthesised
    observations to ``solve_learned_vo_incremental`` (a stand-in returning
    the file's poses here: the accumulator is held in
    ``test_torch_vo_learned.py``); ``--frontend-checkpoint`` without
    ``--checkpoint`` is refused as the JAX CLI refuses it."""
    from tests.test_torch_vo_incremental import tiny_checkpoint

    checkpoint = tiny_checkpoint.__wrapped__(type("F", (), {"mktemp": lambda self, name: tmp_path})())
    base = ["eval-seq", "--gt", KITTI, "--format", "kitti", "--platform", "cpu", "--points", "8", "--checkpoint",
            checkpoint, "--hidden-size", "16", "--transformer-layers", "1", "--transformer-heads", "2", "--restarts",
            "2"]
    assert cli.main(base) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["num_frames"] == 12.0 and np.isfinite(got["rmse"])
    from davo_tpu_torch.data import load_sequence

    truth = load_sequence(KITTI, "kitti", device="cpu").poses
    calls = []

    def stand_in(guess_fn, pixels, visibility, config, **kwargs):
        calls.append((tuple(pixels.shape), visibility.dtype, config.window, kwargs["detections"]))
        return truth

    monkeypatch.setattr(T, "solve_learned_vo_incremental", stand_in)
    assert cli.main(base + ["--pipeline", "incremental"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert calls == [((12, 8, 2), torch.float32, 4, None)] and got["rmse"] < 1e-5  # float32 poses
    with pytest.raises(ValueError, match="requires --checkpoint"):
        cli.run(["eval-seq", "--gt", KITTI, "--format", "kitti", "--platform", "cpu", "--frontend-checkpoint", "x"])
