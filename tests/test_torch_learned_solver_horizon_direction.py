"""8 steps of the direction learned solver against the JAX package's, on its
own draws: ``tests/test_torch_learned_solver_horizon.py`` says how."""

import pytest

from tests.test_torch_learned_solver_horizon import eight_steps_match_jax
from tests.torch_port_helpers import torch_single_thread  # noqa: F401


@pytest.mark.parametrize("case", ["direction"])
def test_eight_steps_match_jax(case):
    eight_steps_match_jax(case)
