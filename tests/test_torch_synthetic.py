"""Parity of the port's synthetic scene generator with the JAX package.

``jax.random`` and ``torch.Generator`` give different numbers from one
seed, so the deterministic part is checked exactly: the JAX package's own
draws (reproduced key by key) go through the port's
``scenes_from_noise`` and must give the JAX package's scenes, in float64
to 1e-9 relative (visibility flags exactly).  The generator-driven path
is checked by the invariants of the sampling scheme.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.data import SceneConfig as JSceneConfig
from davo_tpu.data import generate_batch as j_generate_batch
from davo_tpu_torch.data import SceneConfig, generate_batch, generate_scene, scenes_from_noise
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def _jax_draws(key, batch, m, n, pixel_noise):
    """The standard draws ``davo_tpu.data.generate_scene`` makes, per scene."""
    dtype = jnp.float64

    def one(k):
        k_pts, k_updist, k_target, k_loc, k_tspread, k_upspread, k_fov, k_centre = jax.random.split(k, 8)
        draws = dict(
            z=jax.random.normal(k_pts, (n, 1), dtype),
            xy=jax.random.normal(jax.random.fold_in(k_pts, 1), (n, 2), dtype),
            up_distance=jax.random.normal(k_updist, (), dtype),
            target_scale=jax.random.uniform(k_target, (), dtype),
            target=jax.random.normal(jax.random.fold_in(k_target, 1), (3,), dtype),
            locations=jax.random.normal(k_loc, (m - 1, 3), dtype),
            targets=jax.random.normal(k_tspread, (m - 1, 3), dtype),
            ups=jax.random.normal(k_upspread, (m - 1, 3), dtype),
            fov=jax.random.uniform(k_fov, (), dtype),
            centre=jax.random.normal(k_centre, (2,), dtype),
        )
        if pixel_noise > 0.0:
            draws["pixels"] = jax.random.normal(jax.random.fold_in(k, 101), (m, n, 2), dtype)
        return draws

    return jax.jit(jax.vmap(one))(jax.random.split(key, batch))


@pytest.mark.parametrize("m,n,pixel_noise,fov", [(4, 8, 0.0, (30.0, 120.0)), (3, 5, 0.01, (50.0, 70.0))])
def test_scenes_from_jax_draws_match(m, n, pixel_noise, fov):
    key = jax.random.key(7)
    kwargs = dict(num_views=m, num_points=n, pixel_noise=pixel_noise, fov_min_degrees=fov[0], fov_max_degrees=fov[1])
    expected = jax.jit(lambda k: j_generate_batch(k, 16, JSceneConfig(dtype=jnp.float64, **kwargs)))(key)
    draws = {k: torch.tensor(np.asarray(v)) for k, v in _jax_draws(key, 16, m, n, pixel_noise).items()}
    scenes = scenes_from_noise(draws, SceneConfig(dtype=torch.float64, **kwargs))
    for name, a, b in zip(expected._fields, scenes, expected):
        if name == "visibility_mask":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9, err_msg=name)


def test_generator_path_invariants():
    config = SceneConfig()
    gen = torch.Generator("cpu").manual_seed(0)
    scenes = generate_batch(gen, 256, config, device="cpu")
    b, m, n = 256, config.num_views, config.num_points
    assert scenes.projected_points.shape == (b, m, n, 2)
    assert scenes.visibility_mask.dtype == torch.bool
    assert scenes.camera_orientations.shape == (b, m - 1, 3)
    assert torch.all(torch.isfinite(scenes.projected_points))
    f = scenes.camera_intrinsics[:, 0]
    f_lo, f_hi = 1.0 / np.tan(np.radians(60.0)), 1.0 / np.tan(np.radians(15.0))
    assert torch.all((f >= f_lo - 1e-5) & (f <= f_hi + 1e-5))
    assert torch.all(scenes.camera_intrinsics[:, 1:].abs() <= 0.5)
    assert torch.all(scenes.world_points[..., 2] > 0.0)
    # most observations land in the image, as with the JAX generator
    assert 0.6 < float(scenes.visibility_mask.float().mean()) < 1.0
    # the same seed gives the same scenes; one scene has no batch axis
    again = generate_batch(torch.Generator("cpu").manual_seed(0), 256, config, device="cpu")
    assert torch.equal(again.projected_points, scenes.projected_points)
    one = generate_scene(torch.Generator("cpu").manual_seed(1), config, device="cpu")
    assert one.projected_points.shape == (m, n, 2)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_batch(torch.Generator("cpu"), 2, SceneConfig())
