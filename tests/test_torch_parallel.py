"""The port's multi-device layer at 4 ranks of a gloo group on the CPU,
against the JAX package on its virtual CPU mesh (``tests/conftest.py``).

One module-scoped fixture starts the 4 ranks once
(``tests/torch_parallel_worker.py``, which imports no JAX) and runs every
case in that one group; while they run, the parent computes the JAX
references (``make_mesh(4)``, and a ``(2, 2)`` ``("kf", "pt")`` mesh) and
the port's single-device counterparts.  Each rank is called with the whole
inputs and returns the whole result, so every rank's result must be the
same bits.

Tolerances, float64: gloo sums in another order than XLA's ``psum`` and
the einsums differ in order, so results are held normwise, not bit for
bit: the Schur solves 1e-9 (``test_torch_schur.py``'s, LAPACK LU and
inverses on both sides), the refinement 1e-8 (``test_torch_vo_incremental.py``'s,
through the triangulation), the stitcher 1e-12 against itself on one rank
and the JAX test's rtol 1e-4, atol 5e-5 against the least-squares stitcher
(normal equations against QR), and 1e-9 against JAX's own mesh stitcher
(``slow``, as the JAX package marks its stitcher's cases: JAX takes about
60 s for it on the CPU mesh); the data-parallel step's parameters after 2
steps 1e-10 against the single-device step (it is held against JAX in
``test_torch_train_step.py``), its metrics 1e-10.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from davo_tpu.parallel import BAObservations as JObs
from davo_tpu.parallel import BAProblem as JProblem
from davo_tpu.parallel import SchurConfig as JConfig
from davo_tpu.parallel import distributed_schur_ba as j_distributed_schur_ba
from davo_tpu.parallel import distributed_schur_ba_2d as j_distributed_schur_ba_2d
from davo_tpu.parallel import distributed_stitch_windows as j_distributed_stitch_windows
from davo_tpu.parallel import make_mesh as j_make_mesh
from davo_tpu.train import vo_eval as J
from davo_tpu_torch.geometry import rotate_vector_axis_angle
from davo_tpu_torch.parallel.comm_model import schur_1d_traffic, schur_2d_traffic
from davo_tpu_torch.train import make_train_step
from davo_tpu_torch.train import vo_eval as T
from tests.torch_parallel_worker import dp_run
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
RANKS = 4
M, N = 4, 16  # tests/parallel/test_schur.py's non-slow size
SCHUR_CONFIG = dict(iterations=8, damping=1e-4)
STITCH_FRAMES, STITCH_WINDOW = 8, 4  # tests/parallel/test_pose_graph.py's first case
DP_CASES = {
    # the MLP head (flax BatchNorm over the global batch) through a
    # 2-iteration unrolled solve with drop-path
    "mlp": dict(fields=dict(num_views=3, num_points=4, hidden_size=16, batch_size=8, epochs=1,
                            batches_per_epoch=4, solver=dict(iterations=3, training_iterations=2,
                                                             line_search_iterations=4, drop_path_p=0.25)),
                init_seed=3, step_seeds=(11, 12)),
    # the transformer head with 2 readout tokens (winner-take-all, the
    # token usage entropy of the global batch)
    "transformer_tokens": dict(fields=dict(num_views=3, num_points=4, hidden_size=8, head="transformer",
                                           transformer_layers=1, transformer_heads=2, guess_tokens=2, batch_size=8,
                                           epochs=1, batches_per_epoch=4, solver=dict()),
                               init_seed=4, step_seeds=(21, 22)),
}


def _normwise(actual, expected):
    actual, expected = np.asarray(actual), np.asarray(expected)
    return float(np.max(np.abs(actual - expected)) / max(1.0, float(np.max(np.abs(expected)))))


def _schur_inputs():
    """tests/parallel/test_schur.py's problem (noise 0.02), drawn with numpy
    and projected by the port."""
    rng = np.random.default_rng(0)
    points = np.concatenate([rng.normal(size=(N, 2)) * 2.0, 8.0 + rng.normal(size=(N, 1))], axis=-1)
    poses = np.zeros((M, 6))
    poses[:, 0:3] = rng.normal(size=(M, 3)) * 0.05
    poses[:, 3:5] = rng.normal(size=(M, 2)) * 0.5
    poses[0] = 0.0
    intrinsics = np.array([1.4, 0.05, -0.05])
    rel = rotate_vector_axis_angle(torch.tensor(points)[None], torch.tensor(poses)[:, None, 0:3]).numpy()
    rel = rel + poses[:, None, 3:6]
    pixels = np.stack([1.4 * rel[..., 0] / rel[..., 2] + 0.05, 1.4 * rel[..., 1] / rel[..., 2] - 0.05], axis=-1)
    noise = 0.02
    start_poses = poses.copy()
    start_poses[1:] += noise * rng.normal(size=(M - 1, 6))
    return dict(
        intrinsics=intrinsics + noise * rng.normal(size=3), poses=start_poses,
        points=points + noise * rng.normal(size=(N, 3)), pixels=pixels, visibility=np.ones((M, N), bool),
        config=SCHUR_CONFIG,
    )


def _stitch_inputs():
    """tests/parallel/test_pose_graph.py's windows: true window-relative
    poses of a port trajectory, each window with its own gauge scale and
    noise 0.01."""
    config = T.TrajectoryConfig(num_frames=STITCH_FRAMES, window=STITCH_WINDOW, dtype=torch.float64)
    poses = T.generate_trajectory(torch.Generator().manual_seed(5), config, device="cpu")[0]
    starts = T._window_starts(STITCH_FRAMES, STITCH_WINDOW, STITCH_WINDOW - 2)
    rng = np.random.default_rng(6)
    window_poses = []
    for s in starts:
        rel = T._to_window_frame(poses[s : s + STITCH_WINDOW], poses[s]).numpy()
        rel[:, 3:6] *= np.exp(0.3 * rng.normal())
        rel[1:] += 0.01 * rng.normal(size=(STITCH_WINDOW - 1, 6))
        window_poses.append(rel)
    return dict(starts=starts, window_poses=window_poses, num_frames=STITCH_FRAMES)


def _refine_inputs():
    """A 6-frame sequence of 12 points (4 a rank) with perturbed poses."""
    config = T.TrajectoryConfig(num_frames=6, num_points=12, dtype=torch.float64)
    poses, _, pixels, visibility = T.generate_trajectory(torch.Generator().manual_seed(16), config, device="cpu")
    noise = np.concatenate([np.zeros((1, 6)), 0.01 * np.random.default_rng(4).normal(size=(5, 6))])
    return dict(estimates=poses.numpy() + noise, intrinsics=np.array([config.focal_length, 0.0, 0.0]),
                pixels=pixels.numpy(), visibility=visibility.numpy(), rounds=1)


def _jax_problem(case):
    return (JProblem(*(jnp.asarray(case[k]) for k in ("intrinsics", "poses", "points"))),
            JObs(jnp.asarray(case["pixels"]), jnp.asarray(case["visibility"])))


def _references(inputs):
    """The JAX functions on the virtual CPU mesh, and the port's single
    devices' counterparts."""
    problem, obs = _jax_problem(inputs["schur"])
    config = JConfig(**SCHUR_CONFIG)
    mesh_2d = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("kf", "pt"))
    refine = inputs["refine"]
    return {
        "schur_1d": j_distributed_schur_ba(problem, obs, j_make_mesh(RANKS), config)._asdict(),
        "schur_2d": j_distributed_schur_ba_2d(problem, obs, mesh_2d, config)._asdict(),
        "refine": J.refine_trajectory_global(
            *(jnp.asarray(refine[k]) for k in ("estimates", "intrinsics", "pixels", "visibility")),
            mesh=j_make_mesh(RANKS), rounds=refine["rounds"],
        ),
        "stitch_host": T.stitch_windows_global(
            inputs["stitch"]["starts"], [torch.tensor(w) for w in inputs["stitch"]["window_poses"]],
            inputs["stitch"]["num_frames"],
        ).numpy(),
        **{f"dp_{name}": dp_run(case["fields"], case["init_seed"], case["step_seeds"], make_train_step)
           for name, case in DP_CASES.items()},
    }


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case through one 4-rank gloo group: ``(each rank's results,
    the references)``."""
    work = tmp_path_factory.mktemp("gloo")
    inputs = dict(schur=_schur_inputs(), stitch=_stitch_inputs(), refine=_refine_inputs(), dp=DP_CASES)
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_worker", str(rank), str(RANKS), str(work / "store"),
             str(work / "inputs.pkl"), str(work / "results")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for rank in range(RANKS)
    ]
    try:
        references = _references(inputs)  # while the ranks run
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{log[-4000:]}"
    results = []
    for rank in range(RANKS):
        with open(work / f"results.{rank}", "rb") as f:
            results.append(pickle.load(f))
    return results, references


def _same_on_every_rank(results, name):
    for rank, result in enumerate(results[1:], 1):
        for key, value in dict(result[name]).items():
            np.testing.assert_array_equal(value, dict(results[0][name])[key], err_msg=f"{name} {key} rank {rank}")


@pytest.mark.parametrize("name", ["schur_1d", "schur_2d"])
def test_distributed_schur_ba_matches_jax(ranks, name):
    """``distributed_schur_ba`` on 4 ranks (``"data"``) and
    ``distributed_schur_ba_2d`` on 2 x 2 (``"kf"``, ``"pt"``) against the
    JAX functions on the same meshes: 1e-9 normwise; the solve converged
    to the truth (cost ~0 as the JAX tests assert)."""
    results, references = ranks
    _same_on_every_rank(results, name)
    for key, value in references[name].items():
        assert _normwise(results[0][name][key], value) <= 1e-9, key
    assert _normwise(results[0][name]["poses"][0], np.zeros(6)) == 0.0  # the gauge view did not move


def test_shard_divisibility_is_refused(ranks):
    """What does not divide over the mesh raises ``ValueError`` on every
    rank before any collective: 10 points over 4 ranks, 10 points over
    the 2 x 2 mesh (5 a point shard, not divisible by its 2 keyframe
    rows), 3 views over 2 keyframe rows, ``shard_along`` of 10 rows and a
    data-parallel batch of 6 over 4."""
    results, _ = ranks
    for result in results:
        refusals = result["refusals"]
        assert "num_points=10" in refusals["1d_points_10"]
        assert "num_points=10" in refusals["2d_points_10"]
        assert "num_views=3" in refusals["2d_views_3"]
        assert "does not divide" in refusals["shard_along_10"]
        assert "batch_size=6" in refusals["dp_batch_6"]


def _pairs(traffic, kind="all_reduce"):
    return sorted((kind, t.group_size, t.payload_bytes) for t in traffic for _ in range(t.count))


@pytest.mark.parametrize("name", ["1d", "2d"])
def test_collectives_match_the_comm_model(ranks, name):
    """The collectives a rank issued in a solve of one LM iteration,
    recorded by wrapping ``dist.all_reduce`` and ``dist.all_gather``,
    against the comm model at ``dtype_bytes=8``: one iteration's inventory,
    plus the initial cost (as the JAX test adds it), plus the differences
    listed below with their reasons."""
    results, _ = ranks
    if name == "1d":
        expected = _pairs(schur_1d_traffic(M, N, RANKS, dtype_bytes=8)) + [("all_reduce", RANKS, 8)]
        # the port returns the whole solution on every rank: its points'
        # shards are gathered once, where JAX returns a sharded array
        expected.append(("all_gather", RANKS, N // RANKS * 3 * 8))
    else:
        a = b = 2
        model = schur_2d_traffic(M, N, a, b, dtype_bytes=8)
        names = {t.name for t in model}
        assert {"pose_mask_regather", "step_cost_kf_stage", "step_cost_pt_stage"} <= names
        # every rank holds the whole pose mask: no pose-mask regather; the
        # cost is one all-reduce over the whole mesh where XLA stages one an
        # axis (each iteration and the initial cost)
        kept = [t for t in model if t.name not in ("pose_mask_regather", "step_cost_kf_stage", "step_cost_pt_stage")]
        expected = _pairs(kept) + [("all_reduce", a * b, 8)] * 2
        expected.append(("all_gather", b, N // b * 3 * 8))  # the points' final gather over "pt"
    for result in results:
        assert sorted(result[f"collectives_{name}"]) == sorted(expected)


def test_distributed_stitch_windows(ranks):
    """4 ranks against the same function on a mesh of rank 0 alone (1e-12),
    and against the port's least-squares stitcher at the JAX test's
    tolerance (``stitch_windows_global`` is held against the JAX package in
    ``test_torch_vo_windows.py``)."""
    results, references = ranks
    for result in results[1:]:
        np.testing.assert_array_equal(result["stitch"], results[0]["stitch"])
    assert _normwise(results[0]["stitch"], results[0]["stitch_one_rank"]) <= 1e-12
    np.testing.assert_allclose(results[0]["stitch"], references["stitch_host"], rtol=1e-4, atol=5e-5)


@pytest.mark.slow
def test_distributed_stitch_windows_matches_jax(ranks):
    """4 ranks against JAX's ``distributed_stitch_windows`` on
    ``make_mesh(4)``: 1e-9 normwise (the same normal equations)."""
    results, _ = ranks
    case = _stitch_inputs()
    expected = j_distributed_stitch_windows(
        case["starts"], [jnp.asarray(w) for w in case["window_poses"]], case["num_frames"], j_make_mesh(RANKS)
    )
    assert _normwise(results[0]["stitch"], expected) <= 1e-9


def test_refine_trajectory_global_with_a_mesh_matches_jax(ranks):
    """``refine_trajectory_global(mesh=...)`` (the triangulation and the 1-D
    distributed BA) against the JAX function with ``make_mesh(4)``: 1e-8
    normwise."""
    results, references = ranks
    for result in results[1:]:
        np.testing.assert_array_equal(result["refine"], results[0]["refine"])
    assert _normwise(results[0]["refine"], references["refine"]) <= 1e-8


@pytest.mark.parametrize("name", sorted(DP_CASES))
def test_dp_train_step_matches_single_device(ranks, name):
    """``make_dp_train_step`` at 4 ranks against the single-device
    ``make_train_step`` on generators in the same states, 2 steps, float64:
    parameters and running statistics 1e-10 normwise, metrics 1e-10."""
    results, references = ranks
    metrics, state = results[0][f"dp_{name}"]
    ref_metrics, ref_state = references[f"dp_{name}"]
    for step, (got, expected) in enumerate(zip(metrics, ref_metrics)):
        assert got.keys() == expected.keys()
        for key, value in expected.items():
            assert abs(got[key] - value) <= 1e-10 * max(1.0, abs(value)), (step, key)
    assert state.keys() == ref_state.keys()
    case = DP_CASES[name]
    initial = dp_run(case["fields"], case["init_seed"], (), make_train_step)[1]
    for key, value in ref_state.items():
        assert _normwise(state[key], value) <= 1e-10, key
        # every parameter and running statistic moved
        assert key.endswith("num_batches_tracked") or not np.array_equal(value, initial[key]), key
    for result in results[1:]:
        for key, value in result[f"dp_{name}"][1].items():
            np.testing.assert_array_equal(value, state[key], err_msg=key)


def test_spawned_ranks_import_no_jax(ranks):
    results, _ = ranks
    assert not any(result["imported_jax"] for result in results)
