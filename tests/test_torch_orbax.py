"""The port's Orbax reader (``davo_tpu_torch/train/{ocdbt,zarr,checkpoint}.py``,
numpy only) against the JAX package and tensorstore.

* Every Orbax store under ``artifacts/`` (``ckpt_frontend_v{2,3,4}``,
  ``ckpt_v5_tokens/checkpoint_{600,1800}``) restores tree for tree and
  leaf for leaf (dtype, shape, bytes) as ``davo_tpu.train.restore_checkpoint``
  restores it; its OCDBT key list and every value's bytes are
  tensorstore's; v4 equals ``davo_tpu_torch/weights/frontend_v4.npz`` and
  v5_tokens/1800 ``artifacts/calibration_transformer_v5_tokens8.pkl``,
  whose digest ``chip_smoke.py`` holds the store against on the card.
* Stores tensorstore writes with what Orbax's defaults do not reach (a
  B-tree of several levels with small nodes, version-tree nodes, a
  numbered manifest, no compression) read as tensorstore reads them.
* Fresh JAX saves: a ``fit`` state (``opt_state``, the optax chain, and
  ``step``), a ``fit-frontend`` state, a state sharded over the 8 virtual
  CPU devices (many chunks an array) and a tree of every leaf kind; each
  read by the port equals JAX's restore and the port's read of the same
  state saved with ``format="pickle"`` (tuples read from a pickle, lists
  from Orbax, as JAX restores them).
* ``load_frontend(artifacts/ckpt_frontend_v2)`` on the CPU detects and
  matches as the JAX front end restored from the same directory
  (float32, 1e-5); ``restore_train_state`` resumes a JAX Orbax ``fit``
  checkpoint and ``fit`` continues from it; ``latest_step`` skips Orbax's
  unfinished saves; what the reader does not know raises ``ValueError``.
"""

import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from davo_tpu.train import restore_checkpoint as j_restore_checkpoint
from davo_tpu.train import save_checkpoint as j_save_checkpoint
from davo_tpu_torch.data import VOWindowConfig, generate_vo_window_batch
from davo_tpu_torch.models import FRONTEND_V4, load_frontend, load_frontend_npz, load_numpy_checkpoint
from davo_tpu_torch.models.convert import state_dict_to_flax
from davo_tpu_torch.scripts.time_orbax_reads import PICKLE_DIGESTS, STORES, read_store, tree_digest
from davo_tpu_torch.solve import BFGSConfig
from davo_tpu_torch.train import (
    CalibrationExperiment,
    create_train_state,
    fit,
    latest_step,
    render_scene_batch,
    restore_checkpoint,
)
from davo_tpu_torch.train.calibration import restore_train_state, train_state_tree
from davo_tpu_torch.train.checkpoint import restore_orbax
from davo_tpu_torch.train.ocdbt import OcdbtStore, crc32c
from davo_tpu_torch.train.zarr import read_arrays
from tests.torch_port_helpers import torch_single_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
ARTIFACTS = REPO / "artifacts"


def assert_same_tree(got, want, path="", sequences_alike=False):
    """``got`` has ``want``'s structure and its leaves' dtype, shape and
    bytes; with ``sequences_alike`` a tuple and a list of the same items
    are the same."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, type(got))
        for key in want:
            assert_same_tree(got[key], want[key], f"{path}/{key}", sequences_alike)
    elif isinstance(want, (list, tuple)):
        kinds = (list, tuple) if sequences_alike else type(want)
        assert isinstance(got, kinds) and len(got) == len(want), (path, type(got), type(want))
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}", sequences_alike)
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        assert isinstance(got, np.ndarray), (path, type(got))
        assert (got.dtype, got.shape) == (want.dtype, want.shape), (path, got.dtype, want.dtype, got.shape, want.shape)
        assert got.tobytes() == want.tobytes(), path


@pytest.fixture(scope="module")
def restored():
    """Each artifact store read once by the port (JAX's restore is read in
    the test that compares with it)."""
    return {name: restore_orbax(str(path)) for name, path in STORES.items()}


@pytest.mark.parametrize("name", list(STORES))
def test_artifact_store_restores_as_jax(name, restored):
    path = STORES[name]
    want = j_restore_checkpoint(str(path.parent), int(path.name.split("_")[1]))
    assert_same_tree(restored[name], want)
    if name.startswith("frontend"):  # through the directory's latest step, as the entry points read it
        assert_same_tree(restore_checkpoint(str(path.parent)), want)


def _tensorstore_items(path):
    tensorstore = pytest.importorskip("tensorstore")
    store = tensorstore.KvStore.open({"driver": "ocdbt", "base": f"file://{os.path.abspath(path)}"}).result()
    keys = sorted(store.list().result())
    return keys, [store.read(key).result().value for key in keys]


@pytest.mark.parametrize("name", list(STORES))
def test_ocdbt_keys_and_bytes_are_tensorstores(name):
    store = OcdbtStore(STORES[name])
    keys, values = _tensorstore_items(STORES[name])
    assert store.list() == keys
    assert store.read_many(keys) == values
    assert store.config["compression"] == {"id": "zstd", "level": 0} and store.generation == 1


@pytest.fixture(scope="module")
def tensorstore_stores(tmp_path_factory):
    """Stores tensorstore writes outside Orbax's defaults: many commits
    into small nodes (a B-tree of several levels, version-tree nodes),
    and a numbered manifest without compression."""
    tensorstore = pytest.importorskip("tensorstore")
    root = tmp_path_factory.mktemp("ocdbt")
    configs = {
        "deep": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 20, "version_tree_arity_log2": 1,
                 "compression": {"id": "zstd", "level": 5}},
        "numbered": {"manifest_kind": "numbered", "compression": None, "version_tree_arity_log2": 3},
    }
    for name, config in configs.items():
        kv = tensorstore.KvStore.open({"driver": "ocdbt", "base": f"file://{root / name}", "config": config}).result()
        for commit in range(6):
            with tensorstore.Transaction() as txn:
                for j in range(30):
                    kv.with_transaction(txn)[f"key_{commit}_{j:03d}".encode()] = b"v%d_%d" % (commit, j) * (1 + j % 7)
    return root


@pytest.mark.parametrize("name", ["deep", "numbered"])
def test_stores_beyond_orbax_defaults_read_as_tensorstore(name, tensorstore_stores):
    path = tensorstore_stores / name
    store = OcdbtStore(path)
    keys, values = _tensorstore_items(path)
    assert store.list() == keys and len(keys) == 180
    assert store.read_many(keys) == values
    assert store.read(keys[7]) == values[7]
    if name == "numbered":
        assert store.config["compression"] is None and store.generation > 1


def test_v4_equals_the_npz(restored):
    tree = load_frontend_npz(FRONTEND_V4)
    assert_same_tree(restored["frontend_v4"], tree)


def test_v5_tokens_1800_equals_the_pickle(restored):
    path, digest = PICKLE_DIGESTS["v5_tokens_1800"]
    assert path == "artifacts/calibration_transformer_v5_tokens8.pkl"
    pickled = load_numpy_checkpoint(REPO / path)
    assert_same_tree(restored["v5_tokens_1800"], pickled)
    assert tree_digest(pickled) == tree_digest(restored["v5_tokens_1800"]) == digest
    assert tree_digest(restored["v5_tokens_600"]) != digest


def test_read_store_reports_its_figures():
    read = read_store(STORES["frontend_v2"], repeats=2)
    figures = read["figures"]
    assert figures["store"] == "artifacts/ckpt_frontend_v2/checkpoint_300"
    assert figures["reads"] == 2 and figures["arrays"] == 47
    assert 0 < figures["seconds"] <= figures["first_seconds"]
    assert figures["array_mb"] == pytest.approx(1.128972) and figures["mb_per_s"] > 0
    assert tree_digest(read["tree"]) == tree_digest(restore_orbax(str(STORES["frontend_v2"])))


# ------------------------------------------------------------ fresh saves ----


def _calibration_config(**fields):
    return CalibrationExperiment(
        num_views=3, num_points=4, hidden_size=16, batch_size=4, batches_per_epoch=2, val_batches=1, epochs=2,
        solver=BFGSConfig(iterations=3, training_iterations=2, line_search_iterations=6), **fields,
    )


def _jax_fit_tree():
    """The JAX trainer's checkpoint of its state (``train/calibration.py``'s
    ``fit``: params, batch_stats, the state of ``create_train_state``'s
    optax chain after one update, step) for a 3 x 4 MLP head of width 16
    whose weights are the port's initial ones."""
    params, batch_stats = state_dict_to_flax(_calibration_config().build_network("cpu").state_dict())
    params, batch_stats = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, batch_stats))
    schedule = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 4, 1e-4)
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.adamw(schedule, weight_decay=1e-5))
    grads = jax.tree_util.tree_map(lambda p: 0.01 * jnp.arange(p.size, dtype=p.dtype).reshape(p.shape), params)

    @jax.jit
    def step(params):
        updates, opt_state = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), opt_state

    params, opt_state = step(params)
    return {"params": params, "batch_stats": batch_stats, "opt_state": opt_state, "step": jnp.asarray(1, jnp.int32)}


def _jax_frontend_tree():
    """A ``fit-frontend`` state ({"params", "batch_stats"}): frontend_v2's,
    as JAX arrays, to be saved afresh."""
    tree = j_restore_checkpoint(str(ARTIFACTS / "ckpt_frontend_v2"))
    return jax.tree_util.tree_map(jnp.asarray, {"params": tree["params"], "batch_stats": tree["batch_stats"]})


def _sharded_tree():
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("a", "b"))
    rows = jax.device_put(jnp.arange(64 * 6, dtype=jnp.float32).reshape(64, 6), NamedSharding(mesh, P("a", None)))
    grid = jax.device_put(jnp.linspace(-1, 1, 16 * 10, dtype=jnp.float32).reshape(16, 10),
                          NamedSharding(mesh, P("a", "b")))
    zeros = jax.device_put(jnp.zeros((8, 4), jnp.float32), NamedSharding(mesh, P("a", "b")))
    return {"params": {"rows": rows, "grid": grid, "zeros": zeros}}


def _mixed_tree():
    return {"i": 3, "f": 2.5, "s": np.float32(1.5), "b": jnp.array([True, False]), "i64": np.arange(3),
            "bf": jnp.arange(4, dtype=jnp.bfloat16), "e": (), "l": [], "d": {}, "n": None,
            "t": (jnp.ones(2, jnp.float32), 4, {"x": jnp.zeros(3, jnp.float32)})}


FRESH = {"fit": _jax_fit_tree, "fit_frontend": _jax_frontend_tree, "sharded": _sharded_tree, "mixed": _mixed_tree}


@pytest.mark.parametrize("kind", list(FRESH))
def test_fresh_jax_save_reads_as_jax_and_as_its_pickle(kind, tmp_path):
    tree = FRESH[kind]()
    j_save_checkpoint(str(tmp_path / "orbax"), 3, tree)
    want = j_restore_checkpoint(str(tmp_path / "orbax"))
    got = restore_checkpoint(str(tmp_path / "orbax"))
    assert_same_tree(got, want)
    if kind == "sharded":
        arrays = json.loads((tmp_path / "orbax" / "checkpoint_3" / "_METADATA").read_text())["tree_metadata"]
        assert arrays["('params', 'grid')"]["value_metadata"]["write_shape"] == [4, 5]  # 8 chunks
        np.testing.assert_array_equal(got["params"]["grid"], np.asarray(tree["params"]["grid"]))
    if kind == "mixed":
        return  # its bfloat16 and Python scalars pickle as objects the port's unpickler refuses
    j_save_checkpoint(str(tmp_path / "pickle"), 3, tree, format="pickle")
    assert_same_tree(got, restore_checkpoint(str(tmp_path / "pickle")), sequences_alike=True)


# ----------------------------------------------------- the entry points ----


def test_load_frontend_from_orbax_matches_jax():
    """``vo-eval --frontend-checkpoint artifacts/ckpt_frontend_v2``: the
    port's front end from the Orbax directory against the JAX CLI's
    ``_load_frontend_fn`` from the same directory, on 2 windows rendered at
    its 64 px (by the port: the images are the input of both)."""
    from davo_tpu.cli import _load_frontend_fn

    directory = str(ARTIFACTS / "ckpt_frontend_v2")
    frontend, render_config = load_frontend(directory, device="cpu")
    windows = generate_vo_window_batch(torch.Generator().manual_seed(4), 2, VOWindowConfig(), device="cpu")
    images = render_scene_batch(torch.Generator().manual_seed(5), windows, render_config)
    frontend_fn, detections_fn, render = _load_frontend_fn(directory, default_points=8)
    assert render_config.image_size == render.image_size == 64 and frontend.num_select == 8
    j_points, j_scores = detections_fn(jnp.asarray(images.numpy()))
    j_matches, j_visibility = frontend_fn(jnp.asarray(images.numpy()))
    out = frontend(images)
    np.testing.assert_allclose(out.points.numpy(), np.asarray(j_points), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.sigmoid(out.scores).numpy(), np.asarray(j_scores), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.matches.numpy(), np.asarray(j_matches), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.match_visibility.numpy(), np.asarray(j_visibility))


def test_restore_train_state_resumes_a_jax_orbax_fit(tmp_path):
    tree = _jax_fit_tree()
    j_save_checkpoint(str(tmp_path), 1, tree)
    config = _calibration_config(dtype=torch.float64)
    state = create_train_state(config, "cpu")
    restore_train_state(state, restore_checkpoint(str(tmp_path)))
    assert state.step == 1
    saved = train_state_tree(state)
    adam = tree["opt_state"][1][0]
    for name in ("dense_1", "head"):
        np.testing.assert_array_equal(saved["params"]["initial_estimator"][name]["kernel"],
                                      np.asarray(tree["params"]["initial_estimator"][name]["kernel"], np.float64))
        np.testing.assert_array_equal(saved["opt_state"][1][0]["mu"]["initial_estimator"][name]["kernel"],
                                      np.asarray(adam.mu["initial_estimator"][name]["kernel"], np.float64))
    assert np.abs(saved["opt_state"][1][0]["nu"]["initial_estimator"]["head"]["kernel"]).max() > 0
    # fit finds the JAX checkpoint at epoch 1 and trains epoch 2 from it
    resumed, history = fit(config, device="cpu", checkpoint_dir=str(tmp_path))
    assert len(history["train"]) == 1 and resumed.step == 1 + config.batches_per_epoch
    assert latest_step(str(tmp_path)) == 2


def test_latest_step_skips_unfinished_orbax_saves(tmp_path):
    (tmp_path / "checkpoint_4").mkdir()
    (tmp_path / "checkpoint_9.orbax-checkpoint-tmp-1760000000").mkdir()
    (tmp_path / "checkpoint_12.pkl.tmp").write_bytes(b"")
    assert latest_step(str(tmp_path)) == 4


def _rewrite(path: Path, edit) -> None:
    """``edit`` a framed file's bytes and write it back with its length
    and crc32c made good again."""
    data = bytearray(path.read_bytes())
    edit(data)
    data[4:12] = len(data).to_bytes(8, "little")
    data[-4:] = crc32c(bytes(data[:-4])).to_bytes(4, "little")
    path.write_bytes(bytes(data))


def test_what_the_reader_does_not_know_raises(tmp_path):
    source = STORES["frontend_v2"]

    def copy(name):
        target = tmp_path / name
        shutil.copytree(source, target)
        return target

    version = copy("version")
    _rewrite(version / "manifest.ocdbt", lambda d: d.__setitem__(12, 1))
    with pytest.raises(ValueError, match="format version 1"):
        OcdbtStore(version)
    compression = copy("compression")
    _rewrite(compression / "manifest.ocdbt", lambda d: d.__setitem__(13, 7))
    with pytest.raises(ValueError, match="compression id 7"):
        OcdbtStore(compression)
    damaged = copy("crc")
    data = bytearray((damaged / "manifest.ocdbt").read_bytes())
    data[20] ^= 1
    (damaged / "manifest.ocdbt").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="crc32c"):
        OcdbtStore(damaged)
    # zarr metadata the reader does not take, named in the error
    store = OcdbtStore(source)
    name = "params.matcher.key.bias"
    meta = json.loads(store.read(f"{name}/.zarray"))

    class Edited:
        """``store`` with the array's ``.zarray`` replaced."""

        def __init__(self, **fields):
            self.zarray = json.dumps({**meta, **fields}).encode()

        def list(self):
            return store.list()

        def read_many(self, keys):
            keys = [k.encode() if isinstance(k, str) else k for k in keys]
            return [self.zarray if k == f"{name}/.zarray".encode() else v for k, v in zip(keys, store.read_many(keys))]

    with pytest.raises(ValueError, match="'<u2'"):
        read_arrays(Edited(dtype="<u2"), [name])
    with pytest.raises(ValueError, match="order 'F'"):
        read_arrays(Edited(order="F"), [name])
    with pytest.raises(ValueError, match="compressor"):
        read_arrays(Edited(compressor={"id": "blosc"}), [name])
    # a leaf kind Orbax keeps outside the store
    metadata = copy("string")
    tree = json.loads((metadata / "_METADATA").read_text())
    first = next(iter(tree["tree_metadata"].values()))
    first["value_metadata"]["value_type"] = "string"
    (metadata / "_METADATA").write_text(json.dumps(tree))
    with pytest.raises(ValueError, match="value type 'string'"):
        restore_orbax(str(metadata))


def test_the_reader_imports_no_reference_package():
    """The reader on a host without zstd, tensorstore, Orbax or JAX: those
    imports refused in a fresh process, a store restored there and its
    Orbax front end loaded."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'davo_tpu', 'orbax', 'tensorstore', 'zstandard', 'flax'):\n"
        "            raise ImportError(f'refused: {name}')\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "from davo_tpu_torch.train import restore_checkpoint\n"
        "from davo_tpu_torch.models import load_frontend\n"
        "tree = restore_checkpoint('artifacts/ckpt_frontend_v3')\n"
        "assert tree['params']['matcher']['key']['kernel'].shape == (64, 64)\n"
        "frontend, render = load_frontend('artifacts/ckpt_frontend_v3', device='cpu')\n"
        "assert frontend.num_select == 16 and render.image_size == 64\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'davo_tpu', 'orbax', 'tensorstore', 'zstandard', 'flax')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)
