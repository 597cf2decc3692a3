"""Fixtures shared by the port's parity tests (``tests/test_torch_*.py``).

Each test file imports the fixtures it uses; the data passes between JAX
and PyTorch as numpy arrays.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def torch_single_thread():
    """One torch thread per test worker: the suite runs under xdist."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided inside the test,
    never at import, so every xdist worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA) and nvcc")
    return torch.device("cuda")


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
