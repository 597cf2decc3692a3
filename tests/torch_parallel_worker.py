"""One rank of the 4-rank gloo group of ``tests/test_torch_parallel.py``.

    python -m tests.torch_parallel_worker RANK WORLD STORE INPUTS OUTPUT

The rank joins a gloo process group through the file ``STORE``, runs every
case of the pickled ``INPUTS`` through the port's multi-device layer (each
rank with the whole inputs, as the JAX callers pass global arrays) and
pickles its results to ``OUTPUT.RANK``.  It imports only ``torch``, numpy
and ``davo_tpu_torch``: the JAX references are computed by the parent.
"""

import contextlib
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

RECORDED = []


def _record(kind, group, tensor):
    RECORDED.append((kind, dist.get_world_size(group), tensor.numel() * tensor.element_size()))


@contextlib.contextmanager
def recording():
    """Record every ``dist.all_reduce`` and ``dist.all_gather`` issued
    inside: ``(kind, group size, payload bytes)``."""
    all_reduce, all_gather = dist.all_reduce, dist.all_gather

    def recording_all_reduce(tensor, *args, group=None, **kwargs):
        _record("all_reduce", group, tensor)
        return all_reduce(tensor, *args, group=group, **kwargs)

    def recording_all_gather(tensor_list, tensor, *args, group=None, **kwargs):
        _record("all_gather", group, tensor)
        return all_gather(tensor_list, tensor, *args, group=group, **kwargs)

    RECORDED.clear()
    dist.all_reduce, dist.all_gather = recording_all_reduce, recording_all_gather
    try:
        yield RECORDED
    finally:
        dist.all_reduce, dist.all_gather = all_reduce, all_gather


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _problem(case):
    from davo_tpu_torch.parallel import BAObservations, BAProblem

    problem = BAProblem(*(_t(case[k]) for k in ("intrinsics", "poses", "points")))
    return problem, BAObservations(_t(case["pixels"]), _t(case["visibility"]))


def _numpy(problem):
    return {k: v.numpy() for k, v in problem._asdict().items()}


def _error(fn):
    """The message of the ``ValueError`` ``fn`` raises (None if none)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def _schur_cases(inputs, mesh, mesh_2d):
    from davo_tpu_torch.parallel import SchurConfig, distributed_schur_ba, distributed_schur_ba_2d

    problem, obs = _problem(inputs["schur"])
    config = SchurConfig(**inputs["schur"]["config"])
    out = {
        "schur_1d": _numpy(distributed_schur_ba(problem, obs, mesh, config)),
        "schur_2d": _numpy(distributed_schur_ba_2d(problem, obs, mesh_2d, config)),
    }
    one = SchurConfig(**{**inputs["schur"]["config"], "iterations": 1})
    with recording() as log:
        distributed_schur_ba(problem, obs, mesh, one)
        out["collectives_1d"] = list(log)
    with recording() as log:
        distributed_schur_ba_2d(problem, obs, mesh_2d, one)
        out["collectives_2d"] = list(log)
    return out


def _refusals(inputs, mesh, mesh_2d):
    from davo_tpu_torch.parallel import (
        BAObservations,
        BAProblem,
        distributed_schur_ba,
        distributed_schur_ba_2d,
        make_dp_train_step,
        shard_along,
    )
    from davo_tpu_torch.train import CalibrationExperiment, create_train_state

    problem, obs = _problem(inputs["schur"])

    def points(n):
        return problem._replace(points=problem.points[:n]), BAObservations(obs.pixels[:, :n], obs.visibility[:, :n])

    def views(m):
        return BAProblem(problem.intrinsics, problem.poses[:m], problem.points), BAObservations(
            obs.pixels[:m], obs.visibility[:m]
        )

    state = create_train_state(CalibrationExperiment(num_views=3, num_points=4, hidden_size=8, batch_size=6), "cpu")
    return {
        "1d_points_10": _error(lambda: distributed_schur_ba(*points(10), mesh)),
        "2d_points_10": _error(lambda: distributed_schur_ba_2d(*points(10), mesh_2d)),
        "2d_views_3": _error(lambda: distributed_schur_ba_2d(*views(3), mesh_2d)),
        "shard_along_10": _error(lambda: shard_along(torch.zeros(10, 3), mesh)),
        "dp_batch_6": _error(lambda: make_dp_train_step(state, CalibrationExperiment(batch_size=6), mesh)),
    }


def _stitch_cases(inputs, mesh, rank):
    from torch.distributed.device_mesh import DeviceMesh

    from davo_tpu_torch.parallel import distributed_stitch_windows

    case = inputs["stitch"]
    window_poses = [_t(w) for w in case["window_poses"]]
    out = {"stitch": distributed_stitch_windows(case["starts"], window_poses, case["num_frames"], mesh).numpy()}
    # the same function on a mesh of rank 0 alone
    alone = dist.new_group([0])
    if rank == 0:
        mesh_1 = DeviceMesh.from_group(alone, "cpu", mesh_dim_names=("data",))
        out["stitch_one_rank"] = distributed_stitch_windows(
            case["starts"], window_poses, case["num_frames"], mesh_1
        ).numpy()
    return out


def _refine_case(inputs, mesh):
    from davo_tpu_torch.train.vo_eval import refine_trajectory_global

    case = inputs["refine"]
    poses = refine_trajectory_global(
        *(_t(case[k]) for k in ("estimates", "intrinsics", "pixels", "visibility")), mesh=mesh, rounds=case["rounds"]
    )
    return {"refine": poses.numpy()}


def dp_run(fields, init_seed, step_seeds, step_fn):
    """``len(step_seeds)`` train steps of a float64 experiment from a
    flax-style init drawn by ``init_seed``; ``step_fn(state, config)`` makes
    the step.  Returns each step's metrics, then the network's state."""
    from davo_tpu_torch.solve import BFGSConfig
    from davo_tpu_torch.train import CalibrationExperiment, create_train_state

    fields = dict(fields)
    config = CalibrationExperiment(dtype=torch.float64, solver=BFGSConfig(**fields.pop("solver")), **fields)
    state = create_train_state(config, "cpu", generator=torch.Generator().manual_seed(init_seed))
    step = step_fn(state, config)
    metrics = [
        {k: float(v) for k, v in step(torch.Generator().manual_seed(seed)).items()} for seed in step_seeds
    ]
    return metrics, {k: v.detach().numpy().copy() for k, v in state.network.state_dict().items()}


def _dp_cases(inputs, mesh):
    from davo_tpu_torch.parallel import make_dp_train_step

    return {
        f"dp_{name}": dp_run(case["fields"], case["init_seed"], case["step_seeds"],
                             lambda state, config: make_dp_train_step(state, config, mesh))
        for name, case in inputs["dp"].items()
    }


def main(rank, world, store, inputs_path, output):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    from torch.distributed.device_mesh import init_device_mesh

    from davo_tpu_torch.parallel import make_mesh

    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    mesh = make_mesh(device="cpu")
    mesh_2d = init_device_mesh("cpu", (2, 2), mesh_dim_names=("kf", "pt"))
    results = {}
    results.update(_schur_cases(inputs, mesh, mesh_2d))
    results["refusals"] = _refusals(inputs, mesh, mesh_2d)
    results.update(_stitch_cases(inputs, mesh, rank))
    results.update(_refine_case(inputs, mesh))
    results.update(_dp_cases(inputs, mesh))
    results["imported_jax"] = "jax" in sys.modules or "davo_tpu" in sys.modules
    with open(f"{output}.{rank}", "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
