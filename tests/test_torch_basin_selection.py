"""Basin selection in the network's eval forward: the port against the
JAX package's ``CalibrationNetwork.apply`` for each restart proposal with
``selection="basin"``, with and without the focal anchor, float64 (the
setting and tolerances of ``test_torch_basin_restarts.py``: tiny
transformer, 8 scenes, 3 restarts, the JAX draws injected; solved
parameters to 1e-6 relative to their scale, errors to 1e-6).
"""

import pytest

from tests.test_torch_basin_restarts import network_case, scenes  # noqa: F401
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


@pytest.mark.parametrize(
    "proposals,anchor,tokens",
    [("noise", 0.0, 1), ("permutation", 0.5, 1), ("input_noise", 0.0, 2), ("tokens", 0.5, 3)],
)
def test_network_eval_matches_with_basin_selection(scenes, monkeypatch, proposals, anchor, tokens):  # noqa: F811
    network_case(scenes, monkeypatch, proposals, "basin", anchor, tokens)
