"""YAML experiment configs (the port of ``davo_tpu/train/config_io.py``).

A YAML file picks a named preset and overrides its dataclass fields,
nested blocks (``solver:``, ``scene:``) included:

.. code-block:: yaml

    preset: calibration_from_oracle_matches
    epochs: 100
    head: transformer
    solver:
      iterations: 20
      line_search_iterations: 30

``load_config_yaml`` needs the ``yaml`` package (PyYAML), imported when
it is called, as the JAX module does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

__all__ = ["load_config_yaml", "apply_config_mapping"]

_RESERVED = {"preset"}


def _replace_nested(obj: Any, updates: Mapping[str, Any]) -> Any:
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot apply a mapping to non-dataclass field value {obj!r}")
    names = {f.name for f in dataclasses.fields(obj)}
    resolved = {}
    for key, value in updates.items():
        if key not in names:
            raise KeyError(
                f"unknown config field {key!r} for {type(obj).__name__}; valid fields: {sorted(names)}"
            )
        if isinstance(value, Mapping):
            value = _replace_nested(getattr(obj, key), value)
        resolved[key] = value
    return dataclasses.replace(obj, **resolved)


def apply_config_mapping(config: Any, mapping: Mapping[str, Any]) -> Any:
    """Apply a (possibly nested) mapping of overrides to an experiment
    dataclass, every key checked against the dataclass's fields."""
    return _replace_nested(config, {k: v for k, v in mapping.items() if k not in _RESERVED})


def load_config_yaml(path: str, base: Any = None) -> Any:
    """An experiment config from a YAML file: the optional top-level
    ``preset:`` picks the starting preset (ignored when ``base`` is given),
    every other key overrides a field, nested mappings recursing into
    nested dataclasses.  Unknown keys raise."""
    import yaml

    with open(path) as f:
        mapping = yaml.safe_load(f) or {}
    if not isinstance(mapping, Mapping):
        raise TypeError(f"{path} must contain a YAML mapping, got {mapping!r}")
    if base is None:
        from .presets import get_preset

        base = get_preset(mapping.get("preset", "calibration_from_oracle_matches"))
    return apply_config_mapping(base, mapping)
