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

A state whose leaves are DTensors (training under sharding rules) is saved
by every rank of its mesh together: each leaf is gathered to its full
tensor (a collective), and rank 0 alone writes the files above, the same
files a single card writes.  ``distributed.elastic.restore_for_mesh``
places such a checkpoint, or a single card's, onto any mesh.
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
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models.common import iter_leaves

_STEP_RE = re.compile(r"^step_(\d+)$")
_KEY_RE = re.compile(r"\['([^']*)'\]")


def keystr(path: tuple[str, ...]) -> str:
    """``("opt", "step")`` -> ``"['opt']['step']"`` (jax's keystr of dict keys)."""
    return "".join(f"['{name}']" for name in path)


def _sharded(state: Any) -> bool:
    """Whether any leaf of ``state`` is a DTensor."""
    if not any(isinstance(leaf, torch.Tensor) for _, leaf in iter_leaves(state)):
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(leaf, DTensor) for _, leaf in iter_leaves(state))


def _writer(state: Any) -> bool:
    """Whether this process writes ``state``: always for a plain state; for
    a sharded one, rank 0 of the process group only."""
    if isinstance(state, list) or not _sharded(state):
        return True
    return dist.get_rank() == 0


def host_leaves(state: Any) -> list[tuple[str, np.ndarray, str]]:
    """(key, host array, dtype name) of every leaf in flatten order; a
    tensor is copied off its device (a host tensor is copied too), bf16 as
    its uint16 bits.  A DTensor is gathered to its full tensor first, on
    every rank of its mesh (a collective); only rank 0 keeps the host
    copies, the other ranks get an empty list."""
    from repro_torch.distributed.sharding import gather, is_dtensor

    sharded = _sharded(state)
    keep = _writer(state)
    out = []
    for path, leaf in iter_leaves(state):
        if sharded and is_dtensor(leaf):
            leaf = gather(leaf)
        if not keep:
            continue
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
    :func:`host_leaves`' list).  A sharded state is gathered on every rank
    and written by rank 0.  Returns the checkpoint directory."""
    final = os.path.join(root, f"step_{step:08d}")
    if not isinstance(state, list) and _sharded(state):
        writer = _writer(state)
        leaves = host_leaves(state)
        if writer:
            save(root, step, leaves, extra=extra, keep_last=keep_last)
        dist.barrier()      # the checkpoint is complete when any rank returns
        return final
    os.makedirs(root, exist_ok=True)
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
        self._sharded = False

    def save(self, step: int, state: Any, *, extra: dict | None = None) -> None:
        """Snapshot ``state`` now and write it in the background.  A sharded
        state is gathered on every rank (each rank calls this, and later
        ``wait``) and written by rank 0 alone."""
        self.wait()
        self._sharded = _sharded(state)
        writer = _writer(state)
        snapshot = host_leaves(state)
        if not writer:
            return

        def work():
            try:
                save(self.root, step, snapshot, extra=extra, keep_last=self.keep_last)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the write in flight; after a sharded save, every rank
        waits until rank 0's write is complete (a barrier)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
