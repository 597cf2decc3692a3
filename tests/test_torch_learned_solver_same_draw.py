"""``fit-learned-solver``'s logged epoch 0 at the logged configs, the JAX
package and the port on the JAX package's own draws (slow tier, float64 on
the CPU).

    python -m pytest tests/test_torch_learned_solver_same_draw.py --runslow -s -o addopts=

For each solver type the config is the one its JAX run recorded in its
metrics file's first line (``learned_solver_transformer_r4.jsonl``,
``learned_solver_descent3_metrics.jsonl``,
``learned_solver_direction_metrics.jsonl``: 4 views x 8 points, P = 45,
hidden 256, embed 128, 4 heads, 5 recurrent steps, batch 256, 64 batches
an epoch, constant rate 1e-4), in float64.  Both packages start from the
JAX network's initial parameters (``create_learned_solver_state``'s init
key, seed 0); the JAX side runs its own jitted ``make_learned_solver_step``,
unmodified, with ``fit_learned_solver``'s keys, and each key's scenes and
start noise are drawn outside the step as its ``_make_problem`` draws them
and fed to the port.

At these configs the training is ill-conditioned in float64 (the
solvers' 5 steps carry some scenes where rounding grows 10-1000 times a
step, ``tests/test_torch_learned_solvers.py``): so beside the port, the
JAX package is run a second time from its initial parameters scaled by
``1 + 1e-15 N(0, 1)`` (PERTURBATION), and its parting from the first JAX
run is the yardstick for the port's.

It prints one JSON line a solver type: the epoch-0 means (``final_error``,
``start_error``, ``loss``) of the JAX run, the port and the perturbed JAX
run beside the logged run's (the TPU's, float32, other draws), for the
port and for the perturbed JAX run the largest relative difference of a
step's metrics from the JAX run's and the first step that parts by more
than APART, the port's final parameters' largest difference relative to
the largest parameter, and the seconds.  It asserts every step's
``start_error`` (the draws and the objective only) equal to 1e-12 and the
means finite.
"""

import json
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
LOGS = {
    "transformer": "learned_solver_transformer_r4.jsonl",
    "mlp": "learned_solver_descent3_metrics.jsonl",
    "direction": "learned_solver_direction_metrics.jsonl",
}
APART, PERTURBATION = 1e-9, 1e-15


def _logged(log):
    with open(REPO / "artifacts" / log) as f:
        lines = [json.loads(line) for line in f]
    return lines[0]["run"]["config"], next(r for r in lines[1:] if r.get("split") == "train" and r["epoch"] == 0)


@pytest.mark.slow
@pytest.mark.parametrize("solver_type", sorted(LOGS))
def test_logged_epoch_zero_same_draws(solver_type):
    import davo_tpu.train.learned_solver as jl
    from davo_tpu.camera import calibration_error as j_calibration_error
    from davo_tpu.data import SceneConfig as JSceneConfig
    from davo_tpu_torch import models as tm
    from davo_tpu_torch.train import create_learned_solver_state, make_learned_solver_step
    from tests.test_torch_learned_solver_horizon import _draws, _port_problem
    from tests.test_torch_learned_solver_train import _tx
    from tests.test_torch_learned_solvers import _flat, _to64, configs

    torch.set_num_threads(8)
    logged, logged_epoch = _logged(LOGS[solver_type])
    scene = {k: v for k, v in logged.pop("scene").items() if k != "dtype"}
    assert all(getattr(JSceneConfig(), k) == v for k, v in scene.items())
    assert logged["solver_type"] == solver_type
    j_config, t_config = configs(**logged)
    key = jax.random.key(j_config.seed)
    network = j_config.build_network()
    draws = _draws(j_config)
    # create_learned_solver_state's init: its key's first half, on a problem
    # of 2 from the second half (only the shapes matter to the init)
    init_key, data_key = jax.random.split(key)
    batch, starts, _ = draws(data_key)
    points, visibility = batch.projected_points[:2, None], batch.visibility_mask[:2, None].astype(starts.dtype)
    if solver_type == "direction":
        variables = jax.jit(lambda k, s: network.init({"params": k}, s[:, 0, :], jnp.zeros(()), training=False))(
            init_key, starts[:2])
    else:
        variables = jax.jit(lambda k, s: network.init(
            {"params": k}, s, lambda p: j_calibration_error(p, points, visibility), training=False))(
            init_key, starts[:2])
    variables = _to64(variables)
    j_state = jl.LearnedSolverState.create(apply_fn=network.apply, params=variables["params"],
                                           batch_stats=variables.get("batch_stats", {}), tx=_tx(j_config))
    rng = np.random.default_rng(0)
    p_state = j_state.replace(params=jax.tree_util.tree_map(
        lambda x: x * (1 + PERTURBATION * rng.standard_normal(x.shape)), j_state.params))
    j_train_step = jl.make_learned_solver_step(network, j_config)
    state = create_learned_solver_state(t_config, "cpu")
    tm.load_flax_tree(state.network, variables["params"], variables.get("batch_stats"))
    train_step = make_learned_solver_step(state, t_config)

    def relative(metrics, reference):
        return max(abs(float(metrics[n]) - float(v)) / max(abs(float(v)), 1e-300) for n, v in reference.items())

    start, rows = time.time(), {"jax": [], "port": [], "jax_perturbed": []}
    parting = {side: dict(max_step_metric_rel_diff=0.0, first_step_apart=None) for side in ("port", "jax_perturbed")}
    for i in range(j_config.batches_per_epoch):
        k = jax.random.fold_in(key, 17 + i)
        j_state, j_metrics = j_train_step(j_state, k)
        p_state, p_metrics = j_train_step(p_state, k)
        batch, _, noise = draws(k)
        metrics = train_step(problem=_port_problem(t_config, batch, noise))
        np.testing.assert_allclose(float(metrics["start_error"]), float(j_metrics["start_error"]), rtol=1e-12)
        for side, m in (("port", metrics), ("jax_perturbed", p_metrics)):
            diff = relative(m, j_metrics)
            parting[side]["max_step_metric_rel_diff"] = max(parting[side]["max_step_metric_rel_diff"], diff)
            if parting[side]["first_step_apart"] is None and diff > APART:
                parting[side]["first_step_apart"] = dict(step=i, relative_difference=diff)
        for side, m in (("jax", j_metrics), ("port", metrics), ("jax_perturbed", p_metrics)):
            rows[side].append({n: float(v) for n, v in m.items()})
    heads = j_config.num_heads if solver_type == "transformer" else None
    params, _ = tm.learned_solver_to_flax(state.network.state_dict(), num_heads=heads)
    a, b = _flat(params), _flat(j_state.params)
    scale = max(float(np.abs(v).max()) for v in b.values())
    names = ("final_error", "start_error", "loss")
    line = dict(
        solver_type=solver_type, steps=j_config.batches_per_epoch, batch=j_config.batch_size,
        **{side: {n: float(np.mean([r[n] for r in rows[side]])) for n in names} for side in rows},
        logged_run={n: logged_epoch[n] for n in names}, parting=parting,
        final_params_max_diff_rel_to_largest=max(float(np.abs(a[n] - b[n]).max()) for n in b) / scale,
        seconds=time.time() - start,
    )
    print(json.dumps(line), flush=True)
    assert all(np.isfinite(list(line[side].values())).all() for side in rows)
