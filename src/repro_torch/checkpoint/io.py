"""Checkpoints as path-keyed npz plus a json sidecar; port of
``repro/checkpoint/io.py``, reading and writing the same files.

A tree is a nested dict whose leaves are tensors or numpy arrays; its
npz keys are the "/"-joined dict paths. numpy has no bfloat16, so bf16
leaves are stored as same-width unsigned-int views, with their dtype
names in the archive's ``__encoded_dtypes__`` entry (and a readable copy
in the sidecar). Restoring views them back: bit-exact, with no rounding
through another float type. So the card can run weights saved by the
reference package without JAX.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_ENCODED_KEY = "__encoded_dtypes__"
#: dtype name → (torch dtype, same-width signed view, numpy unsigned view)
_ENCODED = {"bfloat16": (torch.bfloat16, torch.int16, np.uint16)}


def _flatten(tree, prefix="") -> Dict[str, Any]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        else:
            flat[key] = v
    return flat


def _encode(leaf):
    """Leaf → (npz-safe numpy array, encoded dtype name or None)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return leaf.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.name in _ENCODED:
        return arr.view(_ENCODED[arr.dtype.name][2]), arr.dtype.name
    return arr, None


def save_checkpoint(directory: str, step: int, tree: dict,
                    metadata: Optional[dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    arrays, encoded = {}, {}
    for key, leaf in _flatten(tree).items():
        arrays[key], name = _encode(leaf)
        if name is not None:
            encoded[key] = name
    if encoded:
        arrays[_ENCODED_KEY] = np.asarray(json.dumps(encoded))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    meta = {"step": step, **(metadata or {})}
    if encoded:
        meta["encoded_dtypes"] = encoded
    with open(os.path.join(directory, f"ckpt_{step:08d}.json"), "w") as f:
        json.dump(meta, f)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(f[len("ckpt_"):-len(".npz")]) for f in os.listdir(directory)
             if f.startswith("ckpt_") and f.endswith(".npz")]
    return max(steps) if steps else None


def _decode(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name is None:
        return torch.from_numpy(np.ascontiguousarray(arr))
    if name not in _ENCODED:
        raise ValueError(f"unsupported encoded dtype {name!r}")
    dtype, signed, _ = _ENCODED[name]
    return torch.from_numpy(np.ascontiguousarray(arr)).view(signed).view(dtype)


def restore_checkpoint(directory: str, step: Optional[int] = None
                       ) -> Tuple[dict, int]:
    """Read ``ckpt_<step>.npz`` (the latest by default) into a nested dict
    of CPU tensors; returns (tree, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tree: dict = {}
    with np.load(path) as data:
        encoded = {}
        if _ENCODED_KEY in data.files:
            encoded = json.loads(str(data[_ENCODED_KEY]))
        for key in data.files:
            if key == _ENCODED_KEY:
                continue
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = _decode(data[key], encoded.get(key))
    return tree, step
