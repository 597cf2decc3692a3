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

:func:`state_dict_to_flax` is the reverse map, from the port's
``state_dict`` (or a dict of tensors keyed as it is, such as the
optimiser's moments) to flax-named numpy ``params`` and ``batch_stats``:
the port's checkpoints are written in the JAX package's format with it.
:func:`checkpoint_architecture` reads a guess head's architecture (head,
width, layers, heads, readout tokens) from its flax parameters, so
:func:`load_calibration_network` builds, for example, the v5_tokens8
network (8 readout tokens of width 384) from its pickle alone.

:func:`load_numpy_checkpoint` reads a checkpoint pickle with an unpickler
that admits numpy's array globals and nothing else, so it never imports
JAX.  The pickles of plain numpy arrays (``calibration_transformer_300.pkl``
and ``_v2_600.pkl``) name only those; the pickles of JAX arrays
(``_v3_1200.pkl``, ``_v4_1800.pkl``, ...) name one more global,
``jax._src.array._reconstruct_array``, which is read as a numpy stand-in:
it rebuilds the array from its numpy reconstructor and state, as JAX does
before placing the array on a device.  A ``jax.numpy`` scalar type (the
``dtype`` of a pickled experiment config, as in the learned solvers'
``artifacts/learned_solver_descent{,_v2}.pkl``) is read as numpy's type of
the same name.  Any other global is refused.

:func:`flax_tree_state_dict` maps any flax parameter tree onto the
``state_dict`` of a port module whose submodules carry the flax modules'
names (the learned solvers, the gen-1 guess and guess-and-solver models:
:func:`learned_solver_state_dict` and :func:`gen1_state_dict` are this
map), and :func:`flax_tree_from_state_dict` is its reverse
(:func:`learned_solver_to_flax`, :func:`gen1_to_flax`): ``Dense`` kernels
transpose, attention kernels flatten their head axes, norm ``scale``
becomes ``weight``, BatchNorm ``mean``/``var`` the running statistics, and
any other array (an embedding, a learnable constant) keeps its name.
:func:`load_flax_tree` loads such a tree into a module.

:func:`frontend_state_dict` maps a flax ``VOFrontend``'s ``params`` and
``batch_stats`` onto the port's :class:`VOFrontend` (convolution kernels
``HWIO`` become ``OIHW``), and :func:`frontend_state_to_flax` maps the
port's front end back to them (the port's ``fit-frontend`` writes its
checkpoints with it).  The front end's Orbax checkpoint
``artifacts/ckpt_frontend_v4`` is also carried as numpy in
``davo_tpu_torch/weights/frontend_v4.npz`` (keys
``params/detector/enc1_a/conv/kernel`` and so on, equal to the checkpoint
bit for bit, as the tests check) with its ``frontend_config.json`` beside
it as ``frontend_v4.json``; :func:`load_frontend` builds the module from
them, or from a checkpoint directory of either package's ``fit-frontend``
(an Orbax ``checkpoint_<step>/``, as both write, or a
``checkpoint_<step>.pkl``, as the port wrote before, and
``frontend_config.json``), as the JAX
package's ``cli.py::_load_frontend_fn`` does.
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
    "checkpoint_architecture",
    "flax_to_state_dict",
    "load_flax_weights",
    "state_dict_to_flax",
    "load_numpy_checkpoint",
    "load_calibration_network",
    "FRONTEND_V4",
    "load_frontend_npz",
    "frontend_state_dict",
    "frontend_state_to_flax",
    "load_frontend",
    "flax_tree_state_dict",
    "flax_tree_from_state_dict",
    "load_flax_tree",
    "learned_solver_state_dict",
    "learned_solver_to_flax",
    "gen1_state_dict",
    "gen1_to_flax",
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


def _reconstruct_array(fun, args, arr_state, aval_state):
    """``jax._src.array._reconstruct_array`` without JAX: the numpy array
    the JAX array was pickled from (its abstract-value state, such as
    ``weak_type``, has no numpy counterpart and is dropped)."""
    array = fun(*args)
    array.__setstate__(arr_state)
    return array


# the optax states of the JAX trainer's optimiser (clip_by_global_norm,
# adamw): their fields, read as the dict (None for a state with none) that
# the JAX package's Orbax host restore gives for them
_OPTAX_STATES = {
    ("optax._src.base", "EmptyState"): (),
    ("optax._src.transform", "ScaleByAdamState"): ("count", "mu", "nu"),
    ("optax._src.transform", "ScaleByScheduleState"): ("count",),
}


def _optax_state(fields):
    class State:
        def __new__(cls, *values):  # a namedtuple is unpickled as cls.__new__(cls, *fields)
            return dict(zip(fields, values)) if fields else None

    return State


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("jax._src.array", "_reconstruct_array"):
            return _reconstruct_array
        if (module, name) in _OPTAX_STATES:
            return _optax_state(_OPTAX_STATES[module, name])
        if module == "jax.numpy" and isinstance(getattr(np, name, None), type) and issubclass(
            getattr(np, name), np.generic
        ):
            # a scalar type (jax.numpy.float32 in a config's dtype field):
            # numpy's type of the same name
            return getattr(np, name)
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
    """A checkpoint dict (``params``, ``batch_stats``, ...) of numpy arrays,
    from a pickle of numpy or of JAX arrays (the trainer's optax states
    among them read as dicts of their fields, ``None`` for a state with
    none)."""
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
        # without batch_stats (a tree of optimiser moments) no running statistics
        stats = (batch_stats or {}).get("initial_estimator")
        for name in ("dense_1", "dense_2"):
            sd.update(_linear(f"{pre}.{name}", head[name]))
        for name in ("norm_1", "norm_2"):
            sd.update(_norm(f"{pre}.{name}", head[name]))
            if stats is not None:
                sd[f"{pre}.{name}.running_mean"] = np.asarray(stats[name]["mean"])
                sd[f"{pre}.{name}.running_var"] = np.asarray(stats[name]["var"])
    sd.update(_linear(f"{pre}.head", head["head"]))
    return {k: torch.tensor(v) for k, v in sd.items()}


def _unlinear(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _numpy(sd[f"{prefix}.weight"]).T, "bias": _numpy(sd[f"{prefix}.bias"])}


def _unnorm(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _numpy(sd[f"{prefix}.weight"]), "bias": _numpy(sd[f"{prefix}.bias"])}


def _unattention(sd: Mapping, prefix: str, num_heads: int) -> Dict[str, dict]:
    out = {}
    for name in ("query", "key", "value"):
        weight = _numpy(sd[f"{prefix}.{name}.weight"])  # (heads * head_dim, d)
        out[name] = {
            "kernel": weight.T.reshape(weight.shape[1], num_heads, -1),
            "bias": _numpy(sd[f"{prefix}.{name}.bias"]).reshape(num_heads, -1),
        }
    weight = _numpy(sd[f"{prefix}.out.weight"])  # (d, heads * head_dim)
    out["out"] = {"kernel": weight.T.reshape(num_heads, -1, weight.shape[0]), "bias": _numpy(sd[f"{prefix}.out.bias"])}
    return out


def _numpy(x) -> np.ndarray:
    """A copy: a CPU tensor's ``numpy()`` shares the parameter's memory,
    which the optimiser updates in place."""
    return x.detach().cpu().numpy().copy() if isinstance(x, torch.Tensor) else np.array(x)


def state_dict_to_flax(state_dict: Mapping, *, num_heads: Optional[int] = None) -> Tuple[dict, dict]:
    """Flax-named numpy ``(params, batch_stats)`` of a port
    :class:`CalibrationNetwork` ``state_dict``: the reverse of
    :func:`flax_to_state_dict`.  ``num_heads`` splits the transformer
    head's attention projections (required for that head).  Keys without
    running statistics (an optimiser's moments keyed by parameter name)
    give empty ``batch_stats``."""
    pre = "initial_estimator"
    head: dict = {}
    stats: dict = {}
    if f"{pre}.pixel_embed.weight" in state_dict:
        if num_heads is None:
            raise ValueError("num_heads is required to split the transformer head's attention kernels")
        head["pixel_embed"] = _unlinear(state_dict, f"{pre}.pixel_embed")
        for name in ("view_embedding", "point_embedding", "readout_token"):
            head[name] = _numpy(state_dict[f"{pre}.{name}"])
        i = 0
        while f"{pre}.layers.{i}.ln_a.weight" in state_dict:
            layer = f"{pre}.layers.{i}"
            head[f"ln_a_{i}"] = _unnorm(state_dict, f"{layer}.ln_a")
            head[f"attn_{i}"] = _unattention(state_dict, f"{layer}.attn", num_heads)
            head[f"ln_m_{i}"] = _unnorm(state_dict, f"{layer}.ln_m")
            head[f"mlp_in_{i}"] = _unlinear(state_dict, f"{layer}.mlp_in")
            head[f"mlp_out_{i}"] = _unlinear(state_dict, f"{layer}.mlp_out")
            i += 1
        head["ln_out"] = _unnorm(state_dict, f"{pre}.ln_out")
    else:
        for name in ("dense_1", "dense_2"):
            head[name] = _unlinear(state_dict, f"{pre}.{name}")
        for name in ("norm_1", "norm_2"):
            head[name] = _unnorm(state_dict, f"{pre}.{name}")
            if f"{pre}.{name}.running_mean" in state_dict:
                stats[name] = {
                    "mean": _numpy(state_dict[f"{pre}.{name}.running_mean"]),
                    "var": _numpy(state_dict[f"{pre}.{name}.running_var"]),
                }
    head["head"] = _unlinear(state_dict, f"{pre}.head")
    return {pre: head}, ({pre: stats} if stats else {})


def checkpoint_architecture(params: Mapping) -> Dict[str, object]:
    """The :class:`CalibrationNetwork` keywords that fix the guess head's
    shape, read from its flax ``params``: ``head``, ``hidden_size`` and,
    for the transformer head, ``transformer_layers``,
    ``transformer_heads`` and ``guess_tokens``."""
    head = params["initial_estimator"]
    if "pixel_embed" not in head:
        return dict(head="mlp", hidden_size=int(np.shape(head["dense_1"]["kernel"])[1]))
    readout = np.shape(head["readout_token"])  # (E, d)
    layers = 0
    while f"attn_{layers}" in head:
        layers += 1
    return dict(
        head="transformer",
        hidden_size=int(readout[1]),
        transformer_layers=layers,
        transformer_heads=int(np.shape(head["attn_0"]["query"]["kernel"])[1]),
        guess_tokens=int(readout[0]),
    )


def load_calibration_network(
    path: Union[str, Path],
    *,
    device: Optional[Union[str, torch.device]] = None,
    **network_kwargs,
) -> CalibrationNetwork:
    """Build a :class:`CalibrationNetwork` and load a numpy-only checkpoint
    of the JAX package's weights into it.  The head's architecture comes
    from :func:`checkpoint_architecture` where ``network_kwargs`` leaves it
    out."""
    checkpoint = load_numpy_checkpoint(path)
    network_kwargs = {**checkpoint_architecture(checkpoint["params"]), **network_kwargs}
    network = CalibrationNetwork(device=device, **network_kwargs)
    load_flax_weights(network, checkpoint["params"], checkpoint.get("batch_stats"))
    return network


def load_flax_weights(network: CalibrationNetwork, params: Mapping, batch_stats: Optional[Mapping] = None) -> None:
    """Load flax ``params`` (and ``batch_stats``) into ``network``, in place."""
    state = flax_to_state_dict(params, batch_stats)
    # BatchNorm's step counter has no flax counterpart; keep the module's own
    for key, value in network.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = value
    network.load_state_dict(state, strict=True)


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


def _unconv(sd: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _numpy(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}  # OIHW -> HWIO
    if f"{prefix}.bias" in sd:
        out["bias"] = _numpy(sd[f"{prefix}.bias"])
    return out


def frontend_state_to_flax(state_dict: Mapping) -> Tuple[dict, dict]:
    """Flax-named numpy ``(params, batch_stats)`` of the port's
    :class:`VOFrontend` ``state_dict``: the reverse of
    :func:`frontend_state_dict`.  Keys without running statistics (the
    gradients or optimiser moments keyed by parameter name) give empty
    ``batch_stats``."""
    det: dict = {}
    stats: dict = {}
    for name in _CONV_BLOCKS:
        pre = f"detector.{name}"
        det[name] = {"conv": _unconv(state_dict, f"{pre}.conv"), "norm": _unnorm(state_dict, f"{pre}.norm")}
        if f"{pre}.norm.running_mean" in state_dict:
            stats[name] = {"norm": {
                "mean": _numpy(state_dict[f"{pre}.norm.running_mean"]),
                "var": _numpy(state_dict[f"{pre}.norm.running_var"]),
            }}
    det["bottleneck"] = _unconv(state_dict, "detector.bottleneck")
    for name in ("up1", "up2", "up3"):
        det[name] = {"upscale": {"smooth": _unconv(state_dict, f"detector.{name}.upscale.smooth")}}
    det["point_head"] = _unconv(state_dict, "detector.point_head")
    matcher = {name: _unlinear(state_dict, f"matcher.{name}") for name in ("query", "key")}
    return {"detector": det, "matcher": matcher}, ({"detector": stats} if stats else {})


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
    of the same name), or from a checkpoint directory of ``fit-frontend``
    (its latest checkpoint, an Orbax ``checkpoint_<step>/`` or a
    ``checkpoint_<step>.pkl``, and its ``frontend_config.json``, as
    ``vo-eval --frontend-checkpoint artifacts/ckpt_frontend_v4``):
    ``num_select`` (else ``default_points``), ``descriptor_channels``,
    ``embedding_size`` and ``image_size``.  ``gates`` override the
    :class:`VOFrontend` verification-gate defaults."""
    path = Path(path)
    arch_path = path / "frontend_config.json" if path.is_dir() else path.with_suffix(".json")
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
    if path.is_dir():
        from davo_tpu_torch.train.checkpoint import restore_checkpoint  # the trainer's reader imports this module

        tree = restore_checkpoint(str(path))
    else:
        tree = load_frontend_npz(path)
    state = frontend_state_dict(tree["params"], tree.get("batch_stats", {}))
    # BatchNorm's step counter has no flax counterpart; keep the module's own
    for key, value in frontend.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = value
    frontend.load_state_dict(state, strict=True)
    return frontend, render_config


_ATTENTION_PROJECTIONS = ("query", "key", "value", "out")


def _is_attention(path: Tuple[str, ...]) -> bool:
    """``path`` (module names) ends in a projection of a flax
    ``SelfAttention`` (named ``attn`` or ``attn_<i>``)."""
    return len(path) >= 2 and path[-1] in _ATTENTION_PROJECTIONS and path[-2].split("_")[0] == "attn"


def flax_tree_state_dict(params: Mapping, batch_stats: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a port module named as the flax module whose
    ``params`` (and ``batch_stats``) these are.  Without ``batch_stats`` (a
    tree of gradients or optimiser moments) no running statistics."""
    sd: Dict[str, np.ndarray] = {}

    def walk(node: Mapping, path: Tuple[str, ...]):
        prefix = ".".join(path)
        if "kernel" in node:
            kernel = np.asarray(node["kernel"])
            if _is_attention(path) and path[-1] == "out":
                kernel = kernel.reshape(-1, kernel.shape[-1])  # (heads, head_dim, d)
            elif kernel.ndim == 3:
                kernel = kernel.reshape(kernel.shape[0], -1)  # (d, heads, head_dim)
            sd[f"{prefix}.weight"] = kernel.T
            if "bias" in node:
                sd[f"{prefix}.bias"] = np.asarray(node["bias"]).reshape(-1)
            return
        if "scale" in node:
            sd.update(_norm(prefix, node))
            return
        for name, child in node.items():
            if isinstance(child, Mapping):
                walk(child, path + (name,))
            else:
                sd[".".join(path + (name,))] = np.asarray(child)

    def walk_stats(node: Mapping, path: Tuple[str, ...]):
        if "mean" in node and "var" in node:
            prefix = ".".join(path)
            sd[f"{prefix}.running_mean"] = np.asarray(node["mean"])
            sd[f"{prefix}.running_var"] = np.asarray(node["var"])
            return
        for name, child in node.items():
            walk_stats(child, path + (name,))

    walk(params, ())
    walk_stats(batch_stats or {}, ())
    return {k: torch.tensor(v) for k, v in sd.items()}


def flax_tree_from_state_dict(state_dict: Mapping, *, num_heads: Optional[int] = None) -> Tuple[dict, dict]:
    """Flax-named numpy ``(params, batch_stats)`` of a ``state_dict`` keyed
    as :func:`flax_tree_state_dict` makes it (or a dict of tensors keyed
    alike, such as gradients): a two-dimensional ``weight`` is a ``Dense``
    kernel, a one-dimensional one a norm's ``scale``; ``num_heads`` splits
    attention projections (required where there are any)."""
    params: dict = {}
    stats: dict = {}

    def put(tree: dict, path, leaf: str, value) -> None:
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value

    for key, value in state_dict.items():
        *path, leaf = key.split(".")
        path = tuple(path)
        array = _numpy(value)
        if leaf == "num_batches_tracked":
            continue
        if leaf in ("running_mean", "running_var"):
            put(stats, path, "mean" if leaf == "running_mean" else "var", array)
        elif leaf == "weight" and array.ndim == 1:
            put(params, path, "scale", array)
        elif leaf in ("weight", "bias") and _is_attention(path):
            if num_heads is None:
                raise ValueError("num_heads is required to split attention kernels")
            if leaf == "bias" and path[-1] != "out":
                array = array.reshape(num_heads, -1)
            elif leaf == "weight":
                kernel = array.T
                array = (kernel.reshape(num_heads, -1, kernel.shape[-1]) if path[-1] == "out"
                         else kernel.reshape(kernel.shape[0], num_heads, -1))
            put(params, path, "kernel" if leaf == "weight" else "bias", array)
        elif leaf == "weight":
            put(params, path, "kernel", array.T)
        else:
            put(params, path, leaf, array)
    return params, stats


def load_flax_tree(module: torch.nn.Module, params: Mapping, batch_stats: Optional[Mapping] = None) -> None:
    """Load a flax tree into ``module`` (named as the flax module), in
    place and strictly; BatchNorm's step counters stay the module's own."""
    state = flax_tree_state_dict(params, batch_stats)
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = value
    module.load_state_dict(state, strict=True)


# the learned solvers and the gen-1 models are named as their flax modules
learned_solver_state_dict = gen1_state_dict = flax_tree_state_dict
learned_solver_to_flax = gen1_to_flax = flax_tree_from_state_dict
