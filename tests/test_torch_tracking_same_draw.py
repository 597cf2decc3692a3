"""Sequential tracking and the anchor path on the JAX package's own renders:
the JAX package and the port (slow tier, float64 on the CPU).

    python -m pytest tests/test_torch_tracking_same_draw.py --runslow -s -o addopts=

The sequences are ``vo-eval``'s trials 0-3 (``jax.random.key(100 + t)``):
``generate_trajectory`` at 16 frames of 8 points, rendered by the JAX
package's ``render_trajectory_images`` at 96 px (``fold_in(key, 11)``),
as ``chip_smoke.py``'s ``track_sequence`` phase tracks them on the card.
Both packages run ``frontend_v4`` (the JAX package from its Orbax
checkpoint, the port from ``frontend_v4.npz``) with the official gates,
in float64 on the same images: ``track_sequence=True`` (the port's K3
through its plain version on the CPU) and the anchor path (every frame
matched to frame 0, one window of 16 views).

It prints one JSON line a path: each frame's identity share (the share of
the tracks seen there that keep the world point their frame-0 point lies
nearest to) in either package, and the largest difference of the matches
and of their visibility; and it asserts the two packages' matches equal to
MATCH_TOL and their identity curves equal.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FRONTEND_ORBAX = REPO / "artifacts" / "ckpt_frontend_v4"
FRONTEND_NPZ = REPO / "davo_tpu_torch" / "weights" / "frontend_v4.npz"
GATES = dict(nms_radius=0.1, snap_radius=0.12, cycle_threshold=0.15, quality_bonus=10.0, score_threshold=0.2,
             centroid_refine_iters=2)
SEQUENCES, FRAMES, POINTS = 4, 16, 8
MATCH_TOL = 1e-6


def identity_curve(matches, match_visibility, pixels, visibility):
    """Per frame, the share of the tracks seen there whose point lies
    nearest to the true projection of the world point their frame-0 point
    lies nearest to (``chip_smoke.py``'s ``identity_curve``, in numpy)."""
    d2 = np.square(matches[:, :, :, None, :] - pixels[:, :, None, :, :]).sum(-1)  # (S, F, N, P)
    nearest = np.where(visibility[:, :, None, :], d2, np.inf).argmin(-1)
    seen = match_visibility > 0
    same = (nearest == nearest[:, :1]) & seen
    return (same.sum((0, 2)) / np.maximum(seen.sum((0, 2)), 1)).tolist()


@pytest.mark.slow
def test_tracking_on_jax_renders():
    from davo_tpu.data.rendering import RenderConfig
    from davo_tpu.models import VOFrontend
    from davo_tpu.train import restore_checkpoint
    from davo_tpu.train import vo_eval as J
    from davo_tpu_torch.models import load_frontend

    config = J.TrajectoryConfig(num_frames=FRAMES, num_points=POINTS)
    render = RenderConfig(image_size=96)
    images, pixels, visibility = [], [], []
    for trial in range(SEQUENCES):
        key = jax.random.key(100 + trial)
        _, _, px, vis = J.generate_trajectory(key, config)
        images.append(J.render_trajectory_images(px, vis, jax.random.fold_in(key, 11), render))
        pixels.append(np.asarray(px, np.float64))
        visibility.append(np.asarray(vis, bool))
    images = np.stack([np.asarray(x, np.float64) for x in images])
    pixels, visibility = np.stack(pixels), np.stack(visibility)

    restored = restore_checkpoint(str(FRONTEND_ORBAX))
    variables = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                       {"params": restored["params"], "batch_stats": restored["batch_stats"]})
    j_frontend = VOFrontend(num_select=POINTS, descriptor_channels=64, embedding_size=64, **GATES)
    frontend, _ = load_frontend(FRONTEND_NPZ, device="cpu", default_points=POINTS, **GATES)
    frontend = frontend.double()

    for path, track in (("track_sequence", True), ("anchor", False)):
        j_out = jax.jit(lambda v, x, track=track: j_frontend.apply(v, x, track_sequence=track))(
            variables, jnp.asarray(images))
        with torch.no_grad():
            out = frontend(torch.tensor(images), track_sequence=track)
        j_matches, j_vis = np.asarray(j_out.matches), np.asarray(j_out.match_visibility)
        matches, vis = out.matches.numpy(), out.match_visibility.numpy()
        line = dict(
            path=path, shape=list(matches.shape),
            identity_jax=identity_curve(j_matches, j_vis, pixels, visibility),
            identity_port=identity_curve(matches, vis, pixels, visibility),
            max_match_diff=float(np.abs(matches - j_matches).max()),
            max_visibility_diff=float(np.abs(vis.astype(np.float64) - j_vis.astype(np.float64)).max()),
        )
        print(json.dumps(line), flush=True)
        assert matches.shape == (SEQUENCES, FRAMES, POINTS, 2)
        np.testing.assert_allclose(matches, j_matches, rtol=0, atol=MATCH_TOL, err_msg=path)
        np.testing.assert_array_equal(vis, j_vis, err_msg=path)
        assert line["identity_port"] == line["identity_jax"]
