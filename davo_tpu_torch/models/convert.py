"""Carry the JAX package's weights into the port.

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

:func:`frontend_state_dict` maps a flax ``VOFrontend``'s ``params`` and
``batch_stats`` onto the port's :class:`VOFrontend` (convolution kernels
``HWIO`` become ``OIHW``).  The front end's Orbax checkpoint is carried as
numpy in ``davo_tpu_torch/weights/frontend_v4.npz`` (keys
``params/detector/enc1_a/conv/kernel`` and so on, exported once from
``artifacts/ckpt_frontend_v4`` and checked against it by the tests) with
its ``frontend_config.json`` beside it as ``frontend_v4.json``;
:func:`load_frontend` builds the module from them as the JAX package's
``cli.py::_load_frontend_fn`` does.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from davo_tpu_torch.data.rendering import RenderConfig

from .calibration_network import CalibrationNetwork
from .vo_frontend import VOFrontend

__all__ = [
    "flax_to_state_dict",
    "load_numpy_checkpoint",
    "load_calibration_network",
    "FRONTEND_V4",
    "load_frontend_npz",
    "frontend_state_dict",
    "load_frontend",
]

FRONTEND_V4 = Path(__file__).resolve().parents[1] / "weights" / "frontend_v4.npz"
_CONV_BLOCKS = ("enc1_a", "enc1_b", "enc1_c", "enc2", "enc3", "enc4")

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


def load_frontend_npz(path: Union[str, Path]) -> dict:
    """The nested ``{"params": ..., "batch_stats": ...}`` tree of a front
    end's ``.npz`` (keys are ``/``-joined flax paths)."""
    tree: dict = {}
    with np.load(path) as data:
        for name in data.files:
            *parents, leaf = name.split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[name]
    return tree


def _conv(prefix: str, conv: Mapping) -> Dict[str, np.ndarray]:
    out = {f"{prefix}.weight": np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)}  # HWIO -> OIHW
    if "bias" in conv:
        out[f"{prefix}.bias"] = np.asarray(conv["bias"])
    return out


def frontend_state_dict(params: Mapping, batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """The port's :class:`VOFrontend` ``state_dict`` for a flax
    ``VOFrontend``'s ``params`` and ``batch_stats``."""
    det, stats = params["detector"], batch_stats["detector"]
    sd: Dict[str, np.ndarray] = {}
    for name in _CONV_BLOCKS:
        pre = f"detector.{name}"
        sd.update(_conv(f"{pre}.conv", det[name]["conv"]))
        sd.update(_norm(f"{pre}.norm", det[name]["norm"]))
        sd[f"{pre}.norm.running_mean"] = np.asarray(stats[name]["norm"]["mean"])
        sd[f"{pre}.norm.running_var"] = np.asarray(stats[name]["norm"]["var"])
    sd.update(_conv("detector.bottleneck", det["bottleneck"]))
    for name in ("up1", "up2", "up3"):
        sd.update(_conv(f"detector.{name}.upscale.smooth", det[name]["upscale"]["smooth"]))
    sd.update(_conv("detector.point_head", det["point_head"]))
    for name in ("query", "key"):
        sd.update(_linear(f"matcher.{name}", params["matcher"][name]))
    return {k: torch.tensor(v) for k, v in sd.items()}


def load_frontend(
    path: Union[str, Path] = FRONTEND_V4,
    *,
    device: Optional[Union[str, torch.device]] = None,
    default_points: int = 8,
    image_size: int = 64,
    dtype: torch.dtype = torch.float32,
    **gates,
) -> Tuple[VOFrontend, RenderConfig]:
    """The front end and its :class:`RenderConfig` from a ``.npz`` of
    weights and the ``frontend_config.json`` fields beside it (``.json``
    of the same name): ``num_select`` (else ``default_points``),
    ``descriptor_channels``, ``embedding_size`` and ``image_size``.
    ``gates`` override the :class:`VOFrontend` verification-gate defaults."""
    path = Path(path)
    arch_path = path.with_suffix(".json")
    arch = json.loads(arch_path.read_text()) if arch_path.exists() else {}
    render_config = RenderConfig(image_size=arch.pop("image_size", image_size), dtype=dtype)
    frontend = VOFrontend(
        num_select=arch.get("num_select", default_points),
        descriptor_channels=arch.get("descriptor_channels", 64),
        embedding_size=arch.get("embedding_size", 64),
        device=device,
        dtype=dtype,
        **gates,
    )
    tree = load_frontend_npz(path)
    state = frontend_state_dict(tree["params"], tree.get("batch_stats", {}))
    # BatchNorm's step counter has no flax counterpart; keep the module's own
    for key, value in frontend.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = value
    frontend.load_state_dict(state, strict=True)
    return frontend, render_config
