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


def restore_frontend_arrays(checkpoint_dir):
    """The JAX front end's Orbax checkpoint as ``{"params/detector/...":
    array}``, restored through the JAX package (the ``.npz`` the port
    carries is this dict, written by :func:`export_frontend_weights`)."""
    from davo_tpu.train import restore_checkpoint

    restored = restore_checkpoint(str(checkpoint_dir))
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict) or hasattr(node, "items"):
            for name, child in node.items():
                walk(f"{prefix}/{name}" if prefix else str(name), child)
        else:
            flat[prefix] = np.asarray(node)

    walk("", {"params": restored["params"], "batch_stats": restored.get("batch_stats", {})})
    return flat


def export_frontend_weights(checkpoint_dir, npz_path):
    """Write the front end's weights as numpy for the port (run once, where
    JAX and Orbax are installed; the port reads the ``.npz`` without them).
    The checkpoint's ``frontend_config.json`` goes beside it as ``.json``."""
    import shutil
    from pathlib import Path

    np.savez(npz_path, **restore_frontend_arrays(checkpoint_dir))
    shutil.copyfile(Path(checkpoint_dir) / "frontend_config.json", Path(npz_path).with_suffix(".json"))
