"""``compare_with_bfgs`` against the JAX package's, float64: 2 batches of
16 injected starts (3 views x 4 points, P = 27; the JAX experiment's
draws for its keys ``fold_in(key, 900 + i)``) for the direction gate
(hidden 16, two steps), whose learned row is a BFGS eval solve with
``direction_fn`` beside the plain BFGS rows at 2 and 8 iterations (the MLP
solver's learned row is its forward, held in
``test_torch_learned_solvers.py``): every row's objective and focal error
to 1e-8 relative and the basin rates equal (the port's eval solves run
K1's plain version on the CPU).
"""

import jax
import pytest

import davo_tpu.train.learned_solver as jl
from davo_tpu_torch import models as tm
from davo_tpu_torch.train import compare_with_bfgs, make_problem
from tests.test_torch_learned_solver_train import TINY, _tx
from tests.test_torch_learned_solvers import _close, configs, jax_problem, jax_variables
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


def test_compare_with_bfgs_matches_jax():
    j_config, t_config = configs(**dict(TINY, batch_size=16, solver_type="direction"))
    key = jax.random.key(61)
    problems = [jax_problem(j_config, jax.random.fold_in(key, 900 + i)) for i in range(2)]
    network = j_config.build_network()
    variables = jax_variables(network, j_config, problems[0][0][2], problems[0][0][3])
    state = jl.LearnedSolverState.create(apply_fn=network.apply, params=variables["params"],
                                         batch_stats=variables.get("batch_stats", {}), tx=_tx(j_config))
    j_table = jl.compare_with_bfgs(network, state, j_config, key, batches=2)

    t_net = t_config.build_network("cpu")
    tm.load_flax_tree(t_net, variables["params"], variables.get("batch_stats"))
    table = compare_with_bfgs(t_net, t_config, 0, device="cpu",
                              problems=[make_problem(t_config, t_batch, noise) for _, t_batch, noise in problems])
    assert table.keys() == j_table.keys() == {"start", "learned", "bfgs_equal_budget", "bfgs_4x_budget"}
    for solver, row in j_table.items():
        assert table[solver].keys() == row.keys()
        for name in ("objective", "focal_error"):
            _close(table[solver][name], row[name], 1e-8, f"{solver} {name}")
        assert table[solver]["basin_rate"] == pytest.approx(row["basin_rate"], abs=1e-12), solver
    assert j_table["bfgs_4x_budget"]["objective"] < j_table["start"]["objective"]
