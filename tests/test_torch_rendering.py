"""VO windows and their renders: the port against the JAX package, fed the
JAX package's own random draws (float64, 1e-10).

``jax.random`` and torch's generators give different numbers, so the
test re-walks the JAX functions' key tree (``generate_vo_window_batch``,
``render_scene_batch``) to take their draws in unit form and hands them to
the port's ``windows_from_noise`` and ``render_scene_batch(noise=...)``.
Also checked: the augmentation branches (pixel noise, outliers,
visibility dropout), the bilinear background upsampling against
``jax.image.resize``, and the port's own generator path (shapes, bounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from davo_tpu.data import VOWindowConfig as JWindowConfig
from davo_tpu.data import generate_vo_window_batch as j_generate_vo_window_batch
from davo_tpu.data.rendering import RenderConfig as JRenderConfig
from davo_tpu.data.rendering import render_views_nokey as j_render_views_nokey
from davo_tpu.data.rendering import sample_appearance as j_sample_appearance
from davo_tpu.train.frontend import render_scene_batch as j_render_scene_batch
from davo_tpu_torch.data import (
    RenderConfig,
    VOWindowConfig,
    appearance_from_noise,
    generate_vo_window_batch,
    render_views_nokey,
    windows_from_noise,
)
from davo_tpu_torch.data.rendering import _bilinear_weights
from davo_tpu_torch.train import render_scene_batch
from tests.torch_port_helpers import to_numpy, torch_single_thread  # noqa: F401

TOL = 1e-10
AUGMENTED = dict(pixel_noise=0.02, outlier_fraction=0.3, visibility_dropout=0.5)


def _jax_window_draws(key, batch, cfg):
    """The unit draws ``generate_vo_window_batch`` makes, key for key."""
    m, n, dt = cfg.num_views, cfg.num_points, cfg.dtype

    def one(k):
        k_pts, k_radius, k_angle, k_step, k_bob, k_target, k_fov, k_centre = jax.random.split(k, 8)
        d = dict(
            points=jax.random.normal(k_pts, (n, 3), dt),
            radius=jax.random.uniform(k_radius, (), dt),
            start=jax.random.uniform(k_angle, (), dt),
            step=jax.random.uniform(k_step, (), dt),
            bob=jax.random.uniform(k_bob, (), dt),
            target=jax.random.normal(k_target, (3,), dt),
            fov=jax.random.uniform(k_fov, (), dt),
            centre=jax.random.normal(k_centre, (2,), dt),
        )
        if cfg.pixel_noise > 0.0:
            d["pixels"] = jax.random.normal(jax.random.fold_in(k, 101), (m, n, 2), dt)
        if cfg.outlier_fraction > 0.0:
            k_sel, k_other = jax.random.split(jax.random.fold_in(k, 102))
            # bernoulli draws in the probability's type: a Python float
            d["swap"] = jax.random.uniform(k_sel, (m, n), jnp.result_type(float))
            d["shift"] = jax.random.randint(k_other, (m, n), 1, n)
        if cfg.visibility_dropout > 0.0:
            k_rate, k_drop = jax.random.split(jax.random.fold_in(k, 103))
            d["rate"] = jax.random.uniform(k_rate, (m, 1), dt)
            d["drop"] = jax.random.uniform(k_drop, (m, n), dt)
        return d

    draws = jax.vmap(one)(jax.random.split(key, batch))
    return {name: torch.tensor(np.asarray(x)) for name, x in draws.items()}


def _jax_render_draws(key, batch, m, n, cfg):
    """The unit draws ``render_scene_batch`` makes, key for key."""
    dt, cells, s, c = cfg.dtype, cfg.background_cells, cfg.image_size, cfg.channels

    def one(k):
        k_app, k_noise = jax.random.split(k)
        k_col, k_scale, k_theta, k_ecc, k_freq, k_phase = jax.random.split(k_app, 6)
        appearance = dict(
            colour=jax.random.uniform(k_col, (n, 3), dt),
            log_scale=jax.random.normal(k_scale, (n, 1), dt),
            theta=jax.random.uniform(k_theta, (n, 1), dt),
            ecc=jax.random.uniform(k_ecc, (n, 1), dt),
            freq=jax.random.uniform(k_freq, (n, 1), dt),
            phase=jax.random.uniform(k_phase, (n, 1), dt),
        )

        def frame(kf):
            k_bg, k_px = jax.random.split(kf)
            return dict(
                background=jax.random.uniform(k_bg, (cells, cells, c), dt),
                pixels=jax.random.normal(k_px, (s, s, c), dt),
            )

        return appearance, jax.vmap(frame)(jax.random.split(k_noise, m))

    appearance, frame = jax.vmap(one)(jax.random.split(key, batch))
    convert = lambda d: {name: torch.tensor(np.asarray(x)) for name, x in d.items()}  # noqa: E731
    return dict(appearance=convert(appearance), frame=convert(frame))


def _windows(seed, batch, **overrides):
    j_cfg = JWindowConfig(dtype=jnp.float64, **overrides)
    key = jax.random.key(seed)
    expected = j_generate_vo_window_batch(key, batch, j_cfg)
    cfg = VOWindowConfig(dtype=torch.float64, **overrides)
    got = windows_from_noise(_jax_window_draws(key, batch, j_cfg), cfg)
    return expected, got


@pytest.mark.parametrize("overrides", [{}, AUGMENTED], ids=["defaults", "augmented"])
def test_windows_match_jax(overrides):
    expected, got = _windows(3, 16, **overrides)
    for name in expected._fields:
        e, g = np.asarray(getattr(expected, name)), to_numpy(getattr(got, name))
        if e.dtype == bool:
            np.testing.assert_array_equal(g, e, err_msg=name)
        else:
            np.testing.assert_allclose(g, e, rtol=TOL, atol=TOL, err_msg=name)
    if overrides:  # the augmentations really acted
        assert not np.asarray(expected.visibility_mask).all()


@pytest.mark.parametrize("image_size", [32, 20])
def test_render_scene_batch_matches_jax(image_size):
    expected_windows, windows = _windows(5, 3)
    j_cfg = JRenderConfig(image_size=image_size, dtype=jnp.float64)
    key = jax.random.key(11)
    expected = np.asarray(j_render_scene_batch(key, expected_windows, j_cfg))
    noise = _jax_render_draws(key, 3, 4, 8, j_cfg)
    got = render_scene_batch(None, windows, RenderConfig(image_size=image_size, dtype=torch.float64), noise=noise)
    assert got.shape == (3, 4, image_size, image_size, 3)
    np.testing.assert_allclose(to_numpy(got), expected, rtol=TOL, atol=TOL)


def test_sample_appearance_matches_jax():
    j_cfg = JRenderConfig(dtype=jnp.float64)
    key = jax.random.key(2)
    # render_scene_batch takes each scene's appearance key first from its split
    expected = jax.vmap(lambda k: j_sample_appearance(jax.random.split(k)[0], 8, j_cfg))(jax.random.split(key, 2))
    noise = _jax_render_draws(key, 2, 4, 8, j_cfg)["appearance"]
    got = appearance_from_noise(noise, RenderConfig(dtype=torch.float64))
    assert got.shape == (2, 8, 8)
    np.testing.assert_allclose(to_numpy(got), np.asarray(expected), rtol=TOL, atol=TOL)


def test_render_views_nokey_grey_matches_jax():
    expected_windows, windows = _windows(6, 1)
    j_cfg = JRenderConfig(image_size=24, channels=1, dtype=jnp.float64)
    appearance = j_sample_appearance(jax.random.key(4), 8, j_cfg)
    expected = j_render_views_nokey(
        expected_windows.projected_points[0], expected_windows.visibility_mask[0], appearance, j_cfg
    )
    got = render_views_nokey(
        windows.projected_points[0], windows.visibility_mask[0], torch.tensor(np.asarray(appearance)),
        RenderConfig(image_size=24, channels=1, dtype=torch.float64),
    )
    assert got.shape == (4, 24, 24, 1)
    np.testing.assert_allclose(to_numpy(got), np.asarray(expected), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cells,size", [(4, 96), (4, 64), (3, 10)])
def test_background_upsampling_matches_jax_resize(cells, size):
    rng = np.random.default_rng(cells * size)
    bg = rng.random((cells, cells, 3))
    expected = np.asarray(jax.image.resize(jnp.asarray(bg), (size, size, 3), method="bilinear"))
    w = _bilinear_weights(cells, size, torch.float64, "cpu")
    got = torch.einsum("hi,ijc,wj->hwc", w, torch.tensor(bg), w).numpy()
    np.testing.assert_allclose(got, expected, rtol=TOL, atol=TOL)


def test_generator_path_shapes_and_bounds():
    cfg = dataclasses.replace(VOWindowConfig(), **AUGMENTED)
    windows = generate_vo_window_batch(torch.Generator().manual_seed(0), 32, cfg, device="cpu")
    assert windows.projected_points.shape == (32, 4, 8, 2)
    assert windows.visibility_mask.dtype == torch.bool
    focal = windows.camera_intrinsics[:, 0]
    assert torch.all(focal >= 1.0 / np.tan(cfg.max_fov / 2) - 1e-6)
    assert torch.all(focal <= 1.0 / np.tan(cfg.min_fov / 2) + 1e-6)
    images = render_scene_batch(torch.Generator().manual_seed(1), windows, RenderConfig(image_size=16))
    assert images.shape == (32, 4, 16, 16, 3) and torch.isfinite(images).all()
