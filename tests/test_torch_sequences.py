"""TUM and KITTI trajectory files (``data/sequences.py``): the port's
loaders against the JAX package's on ``tests/fixtures/*``, in float64.

Poses (world->camera axis-angle and translation), timestamps and the
normalised intrinsics agree to 1e-12; the association indices exactly;
malformed files raise ``ValueError`` in both packages.
"""

import os

import numpy as np
import pytest
import torch

from davo_tpu.data import sequences as J
from davo_tpu_torch.data import sequences as T
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-12


def _fix(name):
    return os.path.join(FIXTURES, name)


@pytest.mark.parametrize(
    "name,fmt", [("tum_mini_groundtruth.txt", "tum"), ("tum_mini_estimated.txt", "tum"), ("kitti_mini_00.txt", "kitti")]
)
def test_load_sequence_matches_jax(name, fmt):
    expected = J.load_sequence(_fix(name), fmt)
    got = T.load_sequence(_fix(name), fmt, device="cpu", dtype=torch.float64)
    assert got.poses.dtype == torch.float64 and got.poses.device.type == "cpu"
    np.testing.assert_allclose(to_numpy(got.poses), np.asarray(expected.poses), rtol=0, atol=TOL)
    if expected.timestamps is None:
        assert got.timestamps is None
    else:
        np.testing.assert_array_equal(got.timestamps, expected.timestamps)
    assert got.intrinsics is None and expected.intrinsics is None


def test_loaders_return_the_requested_dtype():
    got = T.load_kitti_trajectory(_fix("kitti_mini_00.txt"), device="cpu")
    assert got.poses.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got.poses), np.asarray(J.load_kitti_trajectory(_fix("kitti_mini_00.txt")).poses),
                               rtol=0, atol=1e-5)


def test_intrinsics_match_jax():
    for got, expected in (
        (T.load_tum_intrinsics(_fix("tum_mini_intrinsics.txt"), device="cpu", dtype=torch.float64),
         J.load_tum_intrinsics(_fix("tum_mini_intrinsics.txt"))),
        (T.load_kitti_calib(_fix("kitti_mini_calib.txt"), device="cpu", dtype=torch.float64),
         J.load_kitti_calib(_fix("kitti_mini_calib.txt"))),
        (T.load_tum_intrinsics(_fix("tum_mini_intrinsics.txt"), image_size=(320, 240), device="cpu",
                               dtype=torch.float64),
         J.load_tum_intrinsics(_fix("tum_mini_intrinsics.txt"), image_size=(320, 240))),
    ):
        np.testing.assert_allclose(to_numpy(got), np.asarray(expected), rtol=0, atol=TOL)


@pytest.mark.parametrize("max_dt", [0.02, 0.005, 1e-6])
def test_associate_timestamps_matches_jax(max_dt):
    est = J.load_tum_trajectory(_fix("tum_mini_estimated.txt")).timestamps
    gt = J.load_tum_trajectory(_fix("tum_mini_groundtruth.txt")).timestamps
    rng = np.random.default_rng(3)
    for a, b in ((est, gt), (gt, est), (est + 0.004 * rng.standard_normal(est.shape), gt[::-1])):
        for g, e in zip(T.associate_timestamps(a, b, max_dt), J.associate_timestamps(a, b, max_dt)):
            np.testing.assert_array_equal(g, e)
            assert g.dtype == np.int64


@pytest.mark.parametrize(
    "text,loader",
    [
        ("1.0 2.0 3.0\n", "tum"),
        ("1.0 2.0 3.0\n", "kitti"),
        ("# only a comment\n\n", "tum"),
        ("# only a comment\n", "kitti"),
        ("1 2\n", "tum_intrinsics"),
        ("# nothing\n", "tum_intrinsics"),
        ("P1: 1 2 3\n", "kitti_calib"),
        ("P0: 1 2 3\n", "kitti_calib"),
        ("1 0 0 0 0 1 0 0 0 0 1 0\n", "nope"),
    ],
)
def test_malformed_files_raise_as_in_jax(tmp_path, text, loader):
    bad = tmp_path / "bad.txt"
    bad.write_text(text)
    calls = {
        "tum": (J.load_tum_trajectory, lambda p: T.load_tum_trajectory(p, device="cpu")),
        "kitti": (J.load_kitti_trajectory, lambda p: T.load_kitti_trajectory(p, device="cpu")),
        "tum_intrinsics": (J.load_tum_intrinsics, lambda p: T.load_tum_intrinsics(p, device="cpu")),
        "kitti_calib": (J.load_kitti_calib, lambda p: T.load_kitti_calib(p, device="cpu")),
        "nope": (lambda p: J.load_sequence(p, "nope"), lambda p: T.load_sequence(p, "nope", device="cpu")),
    }[loader]
    messages = []
    for call in calls:
        with pytest.raises(ValueError) as err:
            call(str(bad))
        messages.append(str(err.value).replace(str(bad), "<path>"))
    assert messages[0] == messages[1]


def test_loaders_need_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.load_sequence(_fix("kitti_mini_00.txt"), "kitti")
