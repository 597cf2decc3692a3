"""Carry the JAX package's calibration-network weights into the port.

:func:`flax_to_state_dict` maps flax parameters (a nested dict of numpy
arrays, as ``flax.serialization.to_state_dict`` or a numpy-only checkpoint
holds them) onto :class:`CalibrationNetwork`'s ``state_dict``:

* ``Dense`` kernels ``(in, out)`` become ``Linear`` weights ``(out, in)``;
* ``SelfAttention`` query/key/value kernels ``(d, heads, head_dim)`` and
  biases ``(heads, head_dim)`` flatten their head axes; the output kernel
  ``(heads, head_dim, d)`` flattens the other way;
* ``LayerNorm`` and ``BatchNorm`` ``scale`` become ``weight``; BatchNorm's
  ``batch_stats`` ``mean``/``var`` become the running statistics.

:func:`load_numpy_checkpoint` reads a checkpoint pickle whose arrays are
plain numpy (``calibration_transformer_300.pkl`` and ``_v2_600.pkl``) with
an unpickler that admits numpy's array globals and nothing else, so it
never imports JAX; a pickle of JAX arrays is refused with an error.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from .calibration_network import CalibrationNetwork

__all__ = ["flax_to_state_dict", "load_numpy_checkpoint", "load_calibration_network"]

_NUMPY_GLOBALS = {
    ("numpy", "ndarray"),
    ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
}


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _NUMPY_GLOBALS:
            raise pickle.UnpicklingError(
                f"checkpoint references {module}.{name}; only numpy arrays can be "
                "loaded without JAX"
            )
        if module.startswith("numpy._core"):
            # pickles written under numpy 2 name numpy._core, which numpy 1 lacks
            try:
                return super().find_class(module, name)
            except ModuleNotFoundError:
                module = module.replace("numpy._core", "numpy.core")
        return super().find_class(module, name)


def load_numpy_checkpoint(path: Union[str, Path]) -> dict:
    """A checkpoint dict (``params``, ``batch_stats``, ...) of numpy arrays."""
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()


def _linear(prefix: str, dense: Mapping) -> Dict[str, np.ndarray]:
    return {
        f"{prefix}.weight": np.asarray(dense["kernel"]).T,
        f"{prefix}.bias": np.asarray(dense["bias"]),
    }


def _norm(prefix: str, norm: Mapping) -> Dict[str, np.ndarray]:
    return {f"{prefix}.weight": np.asarray(norm["scale"]), f"{prefix}.bias": np.asarray(norm["bias"])}


def _attention(prefix: str, attn: Mapping) -> Dict[str, np.ndarray]:
    out = {}
    for name in ("query", "key", "value"):
        kernel = np.asarray(attn[name]["kernel"])  # (d, heads, head_dim)
        out[f"{prefix}.{name}.weight"] = kernel.reshape(kernel.shape[0], -1).T
        out[f"{prefix}.{name}.bias"] = np.asarray(attn[name]["bias"]).reshape(-1)
    kernel = np.asarray(attn["out"]["kernel"])  # (heads, head_dim, d)
    out[f"{prefix}.out.weight"] = kernel.reshape(-1, kernel.shape[-1]).T
    out[f"{prefix}.out.bias"] = np.asarray(attn["out"]["bias"])
    return out


def flax_to_state_dict(
    params: Mapping, batch_stats: Optional[Mapping] = None
) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax ``CalibrationNetwork``'s
    ``params`` (and ``batch_stats`` for the MLP head)."""
    head = params["initial_estimator"]
    pre = "initial_estimator"
    sd: Dict[str, np.ndarray] = {}
    if "pixel_embed" in head:
        sd.update(_linear(f"{pre}.pixel_embed", head["pixel_embed"]))
        for name in ("view_embedding", "point_embedding", "readout_token"):
            sd[f"{pre}.{name}"] = np.asarray(head[name])
        i = 0
        while f"attn_{i}" in head:
            layer = f"{pre}.layers.{i}"
            sd.update(_norm(f"{layer}.ln_a", head[f"ln_a_{i}"]))
            sd.update(_attention(f"{layer}.attn", head[f"attn_{i}"]))
            sd.update(_norm(f"{layer}.ln_m", head[f"ln_m_{i}"]))
            sd.update(_linear(f"{layer}.mlp_in", head[f"mlp_in_{i}"]))
            sd.update(_linear(f"{layer}.mlp_out", head[f"mlp_out_{i}"]))
            i += 1
        sd.update(_norm(f"{pre}.ln_out", head["ln_out"]))
    else:
        stats = (batch_stats or {})["initial_estimator"]
        for name in ("dense_1", "dense_2"):
            sd.update(_linear(f"{pre}.{name}", head[name]))
        for name in ("norm_1", "norm_2"):
            sd.update(_norm(f"{pre}.{name}", head[name]))
            sd[f"{pre}.{name}.running_mean"] = np.asarray(stats[name]["mean"])
            sd[f"{pre}.{name}.running_var"] = np.asarray(stats[name]["var"])
    sd.update(_linear(f"{pre}.head", head["head"]))
    return {k: torch.tensor(v) for k, v in sd.items()}


def load_calibration_network(
    path: Union[str, Path],
    *,
    device: Optional[Union[str, torch.device]] = None,
    **network_kwargs,
) -> CalibrationNetwork:
    """Build a :class:`CalibrationNetwork` from ``network_kwargs`` and load a
    numpy-only checkpoint of the JAX package's weights into it."""
    checkpoint = load_numpy_checkpoint(path)
    network = CalibrationNetwork(device=device, **network_kwargs)
    state = flax_to_state_dict(checkpoint["params"], checkpoint.get("batch_stats"))
    # BatchNorm's step counter has no flax counterpart; keep the module's own
    for key, value in network.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = value
    network.load_state_dict(state, strict=True)
    return network
