"""The U-Net detector: the port against the JAX package in float64.

* The whole ``FeatureDetectionModule`` with seeded random parameters and
  BatchNorm statistics, carried across by ``convert.frontend_state_dict``,
  at image sizes 96 (the served front end: asymmetric SAME pads (2, 3)
  and (0, 1) at stride 2, a 2 -> 3 upsampling) and 64: points,
  descriptors and scores to 1e-10.
* flax's SAME padding at the encoder's sizes (1e-10) and ``jax.image.resize(method="nearest")`` at the
  decoder's sizes (2 -> 3, 3 -> 6, 6 -> 12, and 64 px's 1 -> 2 -> 4 -> 8):
  exact.
* ``refine_points_centroid`` against the JAX function: 1e-10.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from davo_tpu.models.detector import FeatureDetectionModule as JDetector
from davo_tpu.models.detector import refine_points_centroid as j_refine_points_centroid
from davo_tpu.models.vo_frontend import VOFrontend as JVOFrontend
from davo_tpu_torch.models import VOFrontend, frontend_state_dict, refine_points_centroid
from davo_tpu_torch.models.detector import _SameConv, same_padding
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

TOL = 1e-10


def random_frontend_variables(seed, image_size, descriptor_channels=64):
    """A flax ``VOFrontend``'s variables with every leaf redrawn from a seed
    (non-zero biases, BatchNorm scales and statistics away from 1 and 0)."""
    net = JVOFrontend(descriptor_channels=descriptor_channels, embedding_size=descriptor_channels)
    images = jnp.zeros((1, 2, image_size, image_size, 3), jnp.float64)
    variables = flax.core.unfreeze(net.init(jax.random.key(seed), images))
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if "kernel" in name:
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(size=shape) / np.sqrt(fan_in)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, size=shape)
        if "'scale'" in name:
            return 1.0 + 0.1 * rng.normal(size=shape)
        return 0.1 * rng.normal(size=shape)  # biases, running means

    return net, jax.tree_util.tree_map_with_path(redraw, variables)


def _port_frontend(variables, descriptor_channels=64):
    frontend = VOFrontend(
        descriptor_channels=descriptor_channels, embedding_size=descriptor_channels, device="cpu", dtype=torch.float64
    )
    state = frontend_state_dict(variables["params"], variables["batch_stats"])
    for key, value in frontend.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = value
    frontend.load_state_dict(state, strict=True)
    return frontend


@pytest.mark.parametrize("image_size", [96, 64])
def test_detector_matches_jax(image_size):
    _, variables = random_frontend_variables(image_size, image_size)
    images = np.random.default_rng(1).random((2, image_size, image_size, 3))
    detector_vars = {"params": variables["params"]["detector"], "batch_stats": variables["batch_stats"]["detector"]}
    expected = JDetector(descriptor_channels=64).apply(detector_vars, jnp.asarray(images))
    got = _port_frontend(variables).detector(torch.tensor(images))
    k = (image_size // 8) ** 2
    assert got.points.shape == (2, k, 2) and got.descriptors.shape == (2, k, 64) and got.scores.shape == (2, k)
    for name in ("points", "descriptors", "scores"):
        np.testing.assert_allclose(
            to_numpy(getattr(got, name)), np.asarray(getattr(expected, name)), rtol=TOL, atol=TOL, err_msg=name
        )


@pytest.mark.parametrize(
    "size,kernel,stride,pads",
    [(96, 7, 2, (2, 3)), (48, 3, 2, (0, 1)), (6, 3, 2, (0, 1)), (3, 3, 2, (1, 1)), (12, 3, 1, (1, 1))],
)
def test_same_padding_is_flax(size, kernel, stride, pads):
    assert same_padding(size, kernel, stride) == pads
    x = jnp.asarray(np.random.default_rng(size).random((1, size, size, 1)))
    conv = flax.linen.Conv(1, (kernel, kernel), strides=(stride, stride), use_bias=False)
    w = conv.init(jax.random.key(0), x)
    expected = conv.apply(w, x)
    conv_port = _SameConv(1, 1, kernel, stride=stride, bias=False).double()
    with torch.no_grad():
        conv_port.weight.copy_(torch.tensor(np.asarray(w["params"]["kernel"])).permute(3, 2, 0, 1))
        got = conv_port(torch.tensor(np.asarray(x)).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(expected), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("src,dst", [(2, 3), (3, 6), (6, 12), (1, 2), (2, 4), (4, 8)])
def test_nearest_upsampling_is_jax_resize(src, dst):
    x = np.arange(src * src, dtype=np.float64).reshape(1, src, src, 1)
    expected = np.asarray(jax.image.resize(jnp.asarray(x), (1, dst, dst, 1), method="nearest"))
    got = F.interpolate(torch.tensor(x).permute(0, 3, 1, 2), size=(dst, dst), mode="nearest-exact")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), expected)
    if (src, dst) == (2, 3):
        np.testing.assert_array_equal(expected[0, :, 0, 0], [0.0, 2.0, 2.0])  # rows [0, 1, 1]


@pytest.mark.parametrize("iters,radius", [(2, 4), (1, 3)])
def test_refine_points_centroid_matches_jax(iters, radius):
    rng = np.random.default_rng(iters + radius)
    images = rng.random((2, 32, 32, 3))
    points = rng.uniform(-1.05, 1.05, size=(2, 10, 2))  # some windows clamp at the edges
    expected = j_refine_points_centroid(jnp.asarray(images), jnp.asarray(points), iters=iters, radius_px=radius)
    got = refine_points_centroid(torch.tensor(images), torch.tensor(points), iters=iters, radius_px=radius)
    np.testing.assert_allclose(to_numpy(got), np.asarray(expected), rtol=TOL, atol=TOL)
