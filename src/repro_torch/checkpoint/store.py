"""The read side of the reference's checkpoint store.

Layout, as ``repro.checkpoint.store.save`` writes it::

    <root>/step_00001000/
        manifest.json        {step, keys: [{key, file, shape, dtype}], extra}
        arr_<i>.npy          one file per leaf

``key`` is the leaf's ``jax.tree_util.keystr`` path, such as
``['params']['layers']['attn']['q']['w']``; :func:`restore` turns the keys
back into a nested dict of tensors on ``device``.  Leaves stored as
``bfloat16`` are raw ``uint16`` on disk: they are read as such and
reinterpreted with ``Tensor.view(torch.bfloat16)``, so no numpy extension
dtype is needed.  Saving comes with training.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

_STEP_RE = re.compile(r"^step_(\d+)$")
_KEY_RE = re.compile(r"\['([^']*)'\]")


def all_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(root, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = all_steps(root)
    return steps[-1] if steps else None


def parse_key(key: str) -> tuple[str, ...]:
    """``"['params']['embed']['table']"`` -> ``("params", "embed", "table")``
    (the reference's states are nested dicts)."""
    parts, pos = [], 0
    for m in _KEY_RE.finditer(key):
        if m.start() != pos:
            break
        parts.append(m.group(1))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"not a key path: {key!r}")
    return tuple(parts)


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path, allow_pickle=False)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(root: str, step: int | None = None, *, device="cuda") -> tuple[dict, dict]:
    """Read checkpoint ``step`` (the latest when None) of ``root`` into a
    nested dict of tensors on ``device``, in their stored dtypes.  Returns
    ``(state, extra)``."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    state: dict[str, Any] = {}
    for entry in manifest["keys"]:
        path = parse_key(entry["key"])
        t = _load_leaf(os.path.join(d, entry["file"]), entry["dtype"])
        if list(t.shape) != list(entry["shape"]):
            raise ValueError(f"{entry['key']}: stored shape {tuple(t.shape)} != manifest "
                             f"{tuple(entry['shape'])}")
        node = state
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = t.to(dev)
    return state, manifest.get("extra", {})
