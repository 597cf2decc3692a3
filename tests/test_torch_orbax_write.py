"""The port's Orbax writer (``davo_tpu_torch/train/{ocdbt,zarr,checkpoint}.py``,
numpy and the standard library only) against the JAX package, Orbax and
tensorstore.  Every comparison is exact: dtype, shape and bytes.

* A tree of every dtype the writer takes (``<f4 <f8 <i4 <i8 |b1`` and
  bfloat16), of Python and numpy scalars and of empty leaves, saved by the
  port: ``davo_tpu.train.restore_checkpoint`` reads it to the host and,
  through ``abstract_state``, onto ``NamedSharding``s of the 8-device CPU
  mesh; the port's ``restore_orbax`` reads it back; its ``_METADATA``
  equals a JAX save's of the same tree.
* OCDBT stores of several B-tree levels (small nodes) read in tensorstore
  as written; an artifact store read, written and read again by
  ``scripts/time_orbax_writes.py`` has one digest.
* The port's ``fit(checkpoint_dir=)`` writes ``checkpoint_1/``, which the
  JAX trainer's resume template (``davo_tpu/train/calibration.py``'s
  ``fit``, built from its ``create_train_state``; float32, as it trains)
  restores to the port's state; a JAX Orbax ``fit`` state and a port
  pickle of the older ``{count, mu, nu}`` layout resume in the port.
* A save cut before its rename leaves no checkpoint; an unsupported
  dtype raises and leaves nothing; a fresh process without JAX, Orbax,
  tensorstore or zstandard writes and reads a checkpoint.  (On the card,
  ``save_checkpoint`` of CUDA tensors: ``tests/test_torch_gpu.py``, which
  imports no JAX, so that the card's test command runs it.)
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import tensorstore as ts
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from davo_tpu.solve import BFGSConfig as JBFGSConfig
from davo_tpu.train import CalibrationExperiment as JCalibrationExperiment
from davo_tpu.train import restore_checkpoint as j_restore_checkpoint
from davo_tpu.train import save_checkpoint as j_save_checkpoint
from davo_tpu.train.calibration import create_train_state as j_create_train_state
from davo_tpu_torch.models.convert import state_dict_to_flax
from davo_tpu_torch.scripts.time_orbax_writes import round_trip
from davo_tpu_torch.scripts.time_orbax_reads import STORES
from davo_tpu_torch.solve import BFGSConfig
from davo_tpu_torch.train import CalibrationExperiment, create_train_state, fit, latest_step, restore_checkpoint
from davo_tpu_torch.train import checkpoint as port_checkpoint
from davo_tpu_torch.train.calibration import restore_train_state, train_state_tree
from davo_tpu_torch.train.checkpoint import restore_orbax, save_checkpoint, save_orbax
from davo_tpu_torch.train.ocdbt import OcdbtStore, write_store
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _same(got, want, path="/"):
    """``got`` has ``want``'s structure (dicts by key, sequences alike,
    empty leaves of the same kind) and each array's dtype, shape and bytes."""
    if isinstance(want, dict) and want:
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _same(got[key], want[key], f"{path}{key}/")
    elif isinstance(want, (list, tuple)) and want:
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}{i}/")
    elif want is None or isinstance(want, (dict, list, tuple)):
        assert got == want and type(got) is type(want), f"{path}: {got!r} for {want!r}"
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), f"{path}: {got.dtype}{got.shape}"
        assert got.tobytes() == want.tobytes(), path


def _every_leaf():
    """Every dtype the writer takes (a float32 array of 64 rows, which the
    mesh shards 8 ways, and arrays past the 1,024 bytes an OCDBT node
    holds inline), scalars of Python and numpy, empty leaves, sequences."""
    rng = np.random.default_rng(18)
    return {
        "params": {
            "f4": rng.standard_normal((64, 5)).astype(np.float32),
            "f8": rng.standard_normal(300),
            "i4": rng.integers(-9, 9, (3, 4), dtype=np.int32),
            "i8": rng.integers(-(2**40), 2**40, 6),
            "b1": rng.random((2, 3)) > 0.5,
            "bf16": rng.standard_normal((16, 8)).astype(ml_dtypes.bfloat16),
            "tensor": torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32)),
        },
        "step": 7, "rate": 0.25, "flag": True, "f32_scalar": np.float32(1.5), "i32_scalar": np.asarray(3, np.int32),
        "empty_dict": {}, "empty_list": [], "empty_tuple": (), "none": None,
        "opt_state": [None, [{"count": np.asarray(2, np.int32), "mu": {"w": np.ones(3, np.float32)}}, None]],
    }


def _as_numpy(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_numpy(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The tree saved by the port and by JAX (its tensor as numpy)."""
    root = tmp_path_factory.mktemp("every_leaf")
    tree = _every_leaf()
    port = save_checkpoint(str(root / "port"), 1, tree)
    jax_path = j_save_checkpoint(str(root / "jax"), 1, _as_numpy(tree))
    return tree, Path(port), Path(jax_path)


def test_every_leaf_restores_in_jax_on_the_host(saved):
    tree, port, jax_path = saved
    want = j_restore_checkpoint(str(jax_path.parent))
    _same(j_restore_checkpoint(str(port.parent)), want)
    _same(want, _as_numpy(tree) | {"empty_tuple": (), "opt_state": want["opt_state"]})
    assert sorted(os.listdir(port)) == ["_CHECKPOINT_METADATA", "_METADATA", "d", "manifest.ocdbt"]


def test_every_leaf_restores_in_jax_onto_the_mesh(saved):
    """``abstract_state`` of ``NamedSharding``s on the 8 CPU devices: the
    64-row array split along its rows, the rest replicated."""
    tree, port, _ = saved
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("d",))

    def abstract(x):
        if isinstance(x, (bool, int, float)):
            return x
        x = np.asarray(_as_numpy(x))
        spec = P("d") if x.shape[:1] == (64,) else P()
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=NamedSharding(mesh, spec))

    restored = j_restore_checkpoint(str(port.parent), abstract_state=jax.tree_util.tree_map(abstract, tree))
    rows = restored["params"]["f4"]
    assert isinstance(rows, jax.Array) and rows.sharding.spec == P("d") and len(rows.addressable_shards) == 8
    assert rows.addressable_shards[1].data.shape == (8, 5)
    leaves = jax.tree_util.tree_leaves(restored)
    assert len(leaves) == len(jax.tree_util.tree_leaves(tree))
    host = jax.tree_util.tree_map(lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, restored)
    _same(host, _as_numpy(tree) | {"step": 7, "rate": 0.25, "flag": True,
                                   "f32_scalar": np.asarray(np.float32(1.5))})


def test_every_leaf_reads_back_in_the_port(saved):
    tree, port, jax_path = saved
    _same(restore_orbax(str(port)), restore_orbax(str(jax_path)))
    want = _as_numpy(tree) | {"step": np.asarray(7), "rate": np.asarray(0.25), "flag": np.asarray(True),
                              "f32_scalar": np.asarray(np.float32(1.5)), "empty_tuple": (),
                              "opt_state": [None, [tree["opt_state"][1][0], None]]}
    _same(restore_checkpoint(str(port.parent), 1), want)


def test_every_leaf_metadata_equals_a_jax_save(saved):
    """Keys, key types, value types (and write shapes, which a host array
    has none of) as JAX writes them for the same tree."""
    _, port, jax_path = saved
    ours, theirs = (json.loads((p / "_METADATA").read_text()) for p in (port, jax_path))
    assert ours == theirs
    assert list(ours["tree_metadata"]) == list(theirs["tree_metadata"])
    ours = json.loads((port / "_CHECKPOINT_METADATA").read_text())
    assert set(ours) == set(json.loads((jax_path / "_CHECKPOINT_METADATA").read_text()))


@pytest.mark.parametrize("limit, inline", [(1200, 200), (500, 32)])
def test_stores_of_several_levels_read_in_tensorstore(tmp_path, limit, inline):
    """Nodes capped at ``limit`` bytes: leaves under two or more levels of
    interior nodes, keys stored relative to their subtree's prefix."""
    rng = np.random.default_rng(limit)
    items = {f"layer_{i // 7}.block_{i % 7}/{'.zarray' if i % 2 else '0.0'}".encode():
             rng.bytes(int(rng.integers(0, 3 * inline))) for i in range(240)}
    write_store(tmp_path, items, max_inline_value_bytes=inline, max_decoded_node_bytes=limit)
    store = OcdbtStore(tmp_path)
    assert store.config["max_decoded_node_bytes"] == limit and store.config["compression"] is None
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/"}).result()
    assert sorted(kv.list().result()) == sorted(items) == store.list()
    for key, value in items.items():
        assert kv.read(key).result().value == value == store.read(key)


def test_an_artifact_store_round_trips(tmp_path):
    """frontend_v2's store read, written by the port and read again (the
    chip run's round trip of every store, at the smallest)."""
    figures = round_trip(STORES["frontend_v2"], tmp_path)
    assert figures["digest_read"] == figures["digest_written"] and figures["write_mb_per_s"] > 0
    _same(restore_checkpoint(str(tmp_path)), j_restore_checkpoint(str(STORES["frontend_v2"].parent)))


def _config(**fields):
    return dict(num_views=3, num_points=4, hidden_size=16, batch_size=4, batches_per_epoch=2, val_batches=1, epochs=1,
                transformer_layers=1, transformer_heads=2, **fields)


@pytest.mark.parametrize("fields", [dict(head="mlp"), dict(head="transformer", schedule="constant")],
                         ids=["mlp", "transformer_constant"])
def test_port_fit_restores_with_the_jax_resume_template(tmp_path, fields):
    """``davo_tpu/train/calibration.py``'s ``fit`` restores its resume with
    ``abstract_state`` from ``create_train_state``'s state (params,
    batch_stats, the optax chain's state, step)."""
    solver = dict(iterations=3, training_iterations=2, line_search_iterations=6)
    config = CalibrationExperiment(solver=BFGSConfig(**solver), **_config(**fields))
    state, _ = fit(config, device="cpu", checkpoint_dir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_1"]
    with jax.enable_x64(False):  # the JAX trainer's dtypes
        # create_train_state's state, its shapes and dtypes drawn without running the init's solve
        j_state = jax.eval_shape(lambda key: j_create_train_state(
            JCalibrationExperiment(solver=JBFGSConfig(**solver), **_config(**fields)), key)[1], jax.random.key(0))
        template = {"params": j_state.params, "batch_stats": j_state.batch_stats, "opt_state": j_state.opt_state,
                    "step": j_state.step}  # jnp.asarray(state.step), abstract
        abstract = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(jnp.shape(x), jnp.result_type(x)), template)
        restored = j_restore_checkpoint(str(tmp_path), 1, abstract_state=abstract)
    assert jax.tree_util.tree_structure(restored["opt_state"]) == jax.tree_util.tree_structure(j_state.opt_state)
    ours = train_state_tree(state)
    assert int(restored["step"]) == ours["step"] == state.step == 2
    for name in ("params", "batch_stats", "opt_state"):
        got, want = (jax.tree_util.tree_leaves_with_path(t[name]) for t in (restored, ours))
        assert len(got) == len(want)
        for (key, g), (_, w) in zip(got, want):
            _same(np.asarray(g), np.asarray(w), jax.tree_util.keystr(key))
    adam = restored["opt_state"][1][0]
    assert int(adam.count) == 2 and np.abs(np.asarray(adam.nu["initial_estimator"]["head"]["kernel"])).max() > 0


def _jax_fit_tree(params):
    """The JAX trainer's checkpoint after one update from ``params``."""
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 4, 1e-4), weight_decay=1e-5))
    grads = jax.tree_util.tree_map(lambda p: 0.01 * jnp.arange(p.size, dtype=p.dtype).reshape(p.shape), params)
    updates, opt_state = tx.update(grads, tx.init(params), params)
    return {"params": optax.apply_updates(params, updates), "opt_state": opt_state, "step": 1}


@pytest.mark.parametrize("kind", ["jax_orbax", "port_pickle_before_the_jax_layout"])
def test_older_and_jax_checkpoints_resume_in_the_port(tmp_path, kind):
    config = CalibrationExperiment(solver=BFGSConfig(iterations=3, training_iterations=2, line_search_iterations=6),
                                   **_config(head="mlp"))
    params, batch_stats = state_dict_to_flax(config.build_network("cpu").state_dict())
    jax_tree = _jax_fit_tree(params)
    adam = jax_tree["opt_state"][1][0]
    mu = jax.tree_util.tree_map(np.asarray, adam.mu)
    if kind == "jax_orbax":
        j_save_checkpoint(str(tmp_path), 1, {**jax_tree, "batch_stats": batch_stats})
    else:  # what the port's fit pickled before it wrote the JAX chain's layout
        old = {"params": jax.tree_util.tree_map(np.asarray, jax_tree["params"]), "batch_stats": batch_stats,
               "opt_state": {"count": 1, "mu": mu, "nu": jax.tree_util.tree_map(np.asarray, adam.nu)}, "step": 1}
        with open(tmp_path / "checkpoint_1.pkl", "wb") as f:
            pickle.dump(old, f)
    state = create_train_state(config, "cpu")
    restore_train_state(state, restore_checkpoint(str(tmp_path)))
    saved = train_state_tree(state)
    assert state.step == 1 and int(saved["opt_state"][1][0]["count"]) == 1
    _same(saved["opt_state"][1][0]["mu"], mu)
    _same(saved["params"], jax.tree_util.tree_map(np.asarray, jax_tree["params"]))


def test_a_save_cut_before_its_rename_is_not_a_checkpoint(tmp_path, monkeypatch):
    save_checkpoint(str(tmp_path), 2, {"w": np.ones(2)})
    # a process killed mid-save leaves its temporary directory
    save_orbax(str(tmp_path / "checkpoint_5.orbax-checkpoint-tmp-1760000000"), {"w": np.ones(2)})

    def cut(*args):
        raise KeyboardInterrupt

    monkeypatch.setattr(port_checkpoint.os, "rename", cut)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(str(tmp_path), 9, {"w": np.zeros(2)})
    assert latest_step(str(tmp_path)) == 2
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_2", "checkpoint_5.orbax-checkpoint-tmp-1760000000"]
    _same(restore_checkpoint(str(tmp_path)), {"w": np.ones(2)})


@pytest.mark.parametrize("leaf, named", [
    (np.zeros(3, np.float16), "'<f2'"), (np.zeros(3, np.uint8), "'|u1'"), (np.zeros(2, np.complex64), "'<c8'"),
    (torch.zeros(3, dtype=torch.int16), "'<i2'"), (np.zeros(3, ">f4"), "'>f4'"), (np.zeros((0, 3), np.float32),
                                                                               "no element"),
    ("text", "a str"),
], ids=["float16", "uint8", "complex64", "int16_tensor", "big_endian", "empty_array", "str"])
def test_an_unsupported_leaf_raises(tmp_path, leaf, named):
    with pytest.raises(ValueError, match=named):
        save_checkpoint(str(tmp_path), 1, {"params": {"ok": np.ones(2, np.float32), "bad": leaf}})
    assert os.listdir(tmp_path) == []


def test_the_writer_imports_no_reference_package(tmp_path):
    """The writer on a host without JAX, Orbax, tensorstore or zstandard:
    those imports refused in a fresh process, a checkpoint written there
    and read back bit for bit."""
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'davo_tpu', 'orbax', 'tensorstore', 'zstandard', 'flax'):\n"
        "            raise ImportError(f'refused: {name}')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import numpy as np, torch\n"
        "from davo_tpu_torch.train import restore_checkpoint, save_checkpoint\n"
        "tree = {'params': {'w': torch.arange(2000.0).reshape(40, 50), 'b': np.arange(3, dtype=np.int32)},\n"
        "        'opt_state': [None, [{'count': np.asarray(4, np.int32)}, None]], 'step': 4}\n"
        f"path = save_checkpoint({str(tmp_path)!r}, 4, tree)\n"
        "back = restore_checkpoint(path.rsplit('/', 1)[0])\n"
        "assert back['params']['w'].tobytes() == tree['params']['w'].numpy().tobytes()\n"
        "assert back['params']['b'].dtype == np.int32 and int(back['step']) == 4\n"
        "assert back['opt_state'][0] is None and int(back['opt_state'][1][0]['count']) == 4\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'davo_tpu', 'orbax', 'tensorstore', 'zstandard', 'flax')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
    assert (tmp_path / "checkpoint_4" / "manifest.ocdbt").is_file()
