"""The front end's weights the port carries as numpy
(``davo_tpu_torch/weights/frontend_v4.npz`` and ``frontend_v4.json``)
against the JAX package's Orbax checkpoint ``artifacts/ckpt_frontend_v4``
restored through ``davo_tpu.train.restore_checkpoint``: the same arrays,
bit for bit, and the same architecture fields, so the copy cannot drift.
The port reads the ``.npz`` without JAX or Orbax (see the import guard in
``test_torch_calibration_network.py``).
"""

import json
from pathlib import Path

import numpy as np

from davo_tpu_torch.models import FRONTEND_V4, frontend_state_dict, load_frontend_npz
from tests.torch_port_helpers import restore_frontend_arrays, torch_single_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
CHECKPOINT = REPO / "artifacts" / "ckpt_frontend_v4"


def test_npz_equals_the_orbax_checkpoint():
    restored = restore_frontend_arrays(CHECKPOINT)
    with np.load(FRONTEND_V4) as carried:
        assert sorted(carried.files) == sorted(restored)
        for name, array in restored.items():
            assert carried[name].dtype == array.dtype, name
            np.testing.assert_array_equal(carried[name], array, err_msg=name)
    assert len(restored) == 47


def test_architecture_fields_are_the_checkpoints():
    carried = json.loads(FRONTEND_V4.with_suffix(".json").read_text())
    original = json.loads((CHECKPOINT / "frontend_config.json").read_text())
    assert carried == original == {"num_select": 8, "descriptor_channels": 64, "embedding_size": 64, "image_size": 96}


def test_state_dict_covers_every_array():
    tree = load_frontend_npz(FRONTEND_V4)
    state = frontend_state_dict(tree["params"], tree["batch_stats"])
    assert len(state) == 47  # one tensor per checkpoint array
    assert tuple(state["detector.enc1_a.conv.weight"].shape) == (8, 5, 7, 7)  # OIHW
    assert tuple(state["matcher.query.weight"].shape) == (64, 64)
