from .mesh import (
    DATA_AXIS,
    initialize_distributed,
    make_mesh,
    replicate,
    shard_along,
)
from .data_parallel import make_dp_train_step
from .schur import (
    BAObservations,
    BAProblem,
    SchurConfig,
    ba_cost,
    ba_residuals,
    default_gauge_masks,
    distributed_schur_ba,
    distributed_schur_ba_2d,
    schur_ba_solve,
    schur_normal_step,
)
from .pose_graph import (
    WindowEdges,
    build_window_edges,
    distributed_stitch_windows,
)

# the JAX package's names; its comm_model module is
# davo_tpu_torch.parallel.comm_model, without the HLO auditor
__all__ = [
    "make_mesh",
    "replicate",
    "shard_along",
    "initialize_distributed",
    "DATA_AXIS",
    "make_dp_train_step",
    "BAProblem",
    "BAObservations",
    "SchurConfig",
    "ba_residuals",
    "ba_cost",
    "schur_normal_step",
    "schur_ba_solve",
    "distributed_schur_ba",
    "distributed_schur_ba_2d",
    "default_gauge_masks",
    "WindowEdges",
    "build_window_edges",
    "distributed_stitch_windows",
]
