"""Run provenance: a run registry without a tracking server (the port of
``davo_tpu/train/runs.py``).

Every training command gets a run ID, a config hash and the git SHA,
stamped into the metrics JSONL (its first record, ``{"run": manifest}``),
the checkpoint directory (``run_manifest.json``) and an append-only
registry (``<registry_dir>/registry.jsonl``).  The registry's format is
the JAX package's, so each package's ``runs`` command reads the other's
rows.  ``backend`` is ``cuda`` or ``cpu`` and ``num_devices`` the count of
cards.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import secrets
import subprocess
import sys
import time
from typing import Any, Dict, Optional

import torch

__all__ = [
    "config_to_jsonable",
    "make_run_manifest",
    "register_run",
    "load_registry",
    "metrics_path_for",
    "final_metrics",
    "compare_runs",
]

DEFAULT_REGISTRY_DIR = "artifacts/runs"


def config_to_jsonable(config: Any) -> Any:
    """A dataclass config as a stable JSON-serialisable structure (dtypes,
    callables and other objects by ``str``)."""
    if dataclasses.is_dataclass(config) and not isinstance(config, type):
        return {f.name: config_to_jsonable(getattr(config, f.name)) for f in dataclasses.fields(config)}
    if isinstance(config, dict):
        return {str(k): config_to_jsonable(v) for k, v in config.items()}
    if isinstance(config, (list, tuple)):
        return [config_to_jsonable(v) for v in config]
    if isinstance(config, (str, int, float, bool)) or config is None:
        return config
    return str(config)


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        )
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return None


def make_run_manifest(
    config: Any = None, *, name: str = "", tags: Optional[Dict[str, str]] = None, argv: Optional[list] = None
) -> Dict[str, Any]:
    """A run manifest: run ID, config hash, git SHA and the environment.
    ``argv`` is the command line to record (``sys.argv`` by default; a
    command run in-process passes its own, whose ``--metrics-file``
    ``final_metrics`` reads)."""
    config_json = config_to_jsonable(config)
    config_blob = json.dumps(config_json, sort_keys=True)
    return {
        "run_id": time.strftime("%Y%m%d-%H%M%S") + "-" + secrets.token_hex(3),
        "name": name,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "git_sha": _git_sha(),
        "config_hash": hashlib.sha256(config_blob.encode()).hexdigest()[:16],
        "config": config_json,
        "argv": list(sys.argv if argv is None else argv),
        "tags": dict(tags or {}),
        "backend": "cuda" if torch.cuda.is_available() else "cpu",
        "num_devices": torch.cuda.device_count(),
    }


def register_run(
    manifest: Dict[str, Any], *, registry_dir: str = DEFAULT_REGISTRY_DIR, checkpoint_dir: Optional[str] = None
) -> str:
    """Append the run to the registry and stamp the checkpoint directory;
    returns the registry's path.  The registry line leaves the config out
    (its hash identifies it; the whole config is in the checkpoint
    directory's ``run_manifest.json`` and the metrics header)."""
    os.makedirs(registry_dir, exist_ok=True)
    registry_path = os.path.join(registry_dir, "registry.jsonl")
    line = {k: v for k, v in manifest.items() if k != "config"}
    line["checkpoint_dir"] = checkpoint_dir
    with open(registry_path, "a") as f:
        f.write(json.dumps(line) + "\n")
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "run_manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
    return registry_path


def load_registry(registry_dir: str = DEFAULT_REGISTRY_DIR) -> list:
    """Every registered run, oldest first (malformed lines skipped)."""
    path = os.path.join(registry_dir, "registry.jsonl")
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue
    return rows


def metrics_path_for(row: Dict[str, Any]) -> Optional[str]:
    """The run's metrics JSONL, from its recorded ``argv``."""
    argv = row.get("argv") or []
    for i, arg in enumerate(argv):
        if arg == "--metrics-file" and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith("--metrics-file="):
            return arg.split("=", 1)[1]
    return None


def final_metrics(row: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """A run's last metric record of each split, read from its metrics
    JSONL: records are attributed by ``run_id`` (a file may hold several
    appended runs), or all taken when the file has no run IDs."""
    path = metrics_path_for(row)
    run_id = row.get("run_id")
    last: Dict[str, Dict[str, float]] = {}
    if not path or not os.path.exists(path):
        return last
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if "split" not in rec:
                continue
            if "run_id" in rec and run_id is not None and rec["run_id"] != run_id:
                continue
            last[rec["split"]] = {
                k: v for k, v in rec.items() if isinstance(v, (int, float)) and k != "epoch"
            } | {"epoch": rec.get("epoch")}
    return last


def compare_runs(rows: list, split: str = "val") -> Dict[str, Any]:
    """Several runs' final metrics side by side, and the config keys on
    which they differ.

    :return: ``{"metrics": {metric: {run_id: value}}, "config_diff":
        {path: {run_id: value}}}``; each config comes from the checkpoint
        directory's ``run_manifest.json`` where there is one, else the row.
    """

    def flatten(prefix, obj, out):
        if isinstance(obj, dict):
            for k, v in obj.items():
                flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
        else:
            out[prefix] = obj

    metrics: Dict[str, Dict[str, Any]] = {}
    configs: Dict[str, Dict[str, Any]] = {}
    for row in rows:
        run_id = row.get("run_id", "?")
        for name, value in final_metrics(row).get(split, {}).items():
            metrics.setdefault(name, {})[run_id] = value
        config = row.get("config")
        ckpt = row.get("checkpoint_dir")
        if config is None and ckpt:
            manifest_path = os.path.join(ckpt, "run_manifest.json")
            if os.path.exists(manifest_path):
                try:
                    with open(manifest_path) as f:
                        config = json.load(f).get("config")
                except (OSError, ValueError):
                    config = None
        flat: Dict[str, Any] = {}
        flatten("", config or {}, flat)
        configs[run_id] = flat
    config_diff = {}
    for k in sorted({k for c in configs.values() for k in c}):
        values = {rid: c.get(k) for rid, c in configs.items()}
        if len({json.dumps(v, sort_keys=True) for v in values.values()}) > 1:
            config_diff[k] = values
    return {"metrics": metrics, "config_diff": config_diff}
