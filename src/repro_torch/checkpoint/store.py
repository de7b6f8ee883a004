"""The reference's checkpoint store: atomic saves, garbage collection, a
background writer, and restore.

Layout, as ``repro.checkpoint.store.save`` writes it::

    <root>/step_00001000/
        manifest.json        {step, keys: [{key, file, shape, dtype}], extra}
        arr_<i>.npy          one file per leaf
    <root>/step_00001000.tmp (during a write; renamed on success)

``key`` is the leaf's ``jax.tree_util.keystr`` path, such as
``['opt']['master']['layers']['attn']['q']['w']``, and the leaves of a
state (nested dicts of tensors or arrays) are numbered in sorted key
order, the order ``jax.tree_util`` flattens dicts in, so a checkpoint
written by either package opens in the other.  Leaves of ``bfloat16`` are
raw ``uint16`` on disk with the dtype ``"bfloat16"`` in the manifest:
written through ``Tensor.view`` and read back the same way, so no numpy
extension dtype is needed.

* :func:`save` writes into ``.tmp`` and renames it with ``os.replace``, so
  a crash mid-write never leaves a partial checkpoint, then drops all but
  the ``keep_last`` newest steps (:func:`_gc`).
* :class:`AsyncCheckpointer` copies the state to host memory at once (the
  training step may then update its tensors in place) and writes it on a
  background thread; a failed write raises at the next ``wait()``.
* :func:`restore` turns the keys back into a nested dict of tensors on
  ``device``, in their stored dtypes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import iter_leaves

_STEP_RE = re.compile(r"^step_(\d+)$")
_KEY_RE = re.compile(r"\['([^']*)'\]")


def keystr(path: tuple[str, ...]) -> str:
    """``("opt", "step")`` -> ``"['opt']['step']"`` (jax's keystr of dict keys)."""
    return "".join(f"['{name}']" for name in path)


def host_leaves(state: Any) -> list[tuple[str, np.ndarray, str]]:
    """(key, host array, dtype name) of every leaf in flatten order; a
    tensor is copied off its device (a host tensor is copied too), bf16 as
    its uint16 bits."""
    out = []
    for path, leaf in iter_leaves(state):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                out.append((keystr(path), t.view(torch.int16).numpy().view(np.uint16),
                            "bfloat16"))
                continue
            arr = t.numpy()
        else:
            arr = np.array(leaf, copy=True)
        out.append((keystr(path), arr, str(arr.dtype)))
    return out


def save(root: str, step: int, state: Any, *, extra: dict | None = None,
         keep_last: int = 3) -> str:
    """Synchronous atomic save of a nested dict of tensors (or arrays, or
    :func:`host_leaves`' list).  Returns the checkpoint directory."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = state if isinstance(state, list) else host_leaves(state)
    manifest = {"step": int(step), "keys": [], "extra": extra or {}}
    for i, (key, arr, dtype) in enumerate(leaves):
        np.save(os.path.join(tmp, f"arr_{i}.npy"), arr, allow_pickle=False)
        manifest["keys"].append({"key": key, "file": f"arr_{i}.npy",
                                 "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(root, keep_last)
    return final


def _gc(root: str, keep_last: int) -> None:
    steps = all_steps(root)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)


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


class AsyncCheckpointer:
    """Snapshot-then-write-in-background checkpointer."""

    def __init__(self, root: str, *, keep_last: int = 3):
        self.root = root
        self.keep_last = keep_last
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state: Any, *, extra: dict | None = None) -> None:
        self.wait()
        snapshot = host_leaves(state)

        def work():
            try:
                save(self.root, step, snapshot, extra=extra, keep_last=self.keep_last)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
