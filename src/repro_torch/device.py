"""Device resolution and host/device array conversion for the port.

Every entry point of ``repro_torch`` takes an explicit ``device``; the
default is ``"cuda"``.  :func:`resolve_device` turns the argument into a
``torch.device`` and raises when the card is asked for and absent -- the
port never falls back to the CPU on its own.  Only an explicit
``device="cpu"`` runs on the host (the tests always pass it).  In a dry
run (:func:`dry_run`, ``launch/dryrun.py``) a tensor has shapes and no
data, so ``"cuda"`` needs no card.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    """``"cuda"`` / ``"cuda:1"`` / ``"cpu"`` / a ``torch.device`` -> a
    ``torch.device``, raising ``RuntimeError`` when CUDA is asked for but no
    card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available() and not dry_run():
        raise RuntimeError(
            f"device={str(dev)!r} was requested but no CUDA device is available;"
            " pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda | cpu)")
    return dev


def dry_run(*tensors: torch.Tensor) -> bool:
    """Whether this is a dry run: a ``FakeTensorMode`` is active (tensors
    made now carry shapes and dtypes and no data) and every one of
    ``tensors`` is fake."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import is_fake

    return detect_fake_mode() is not None and all(is_fake(t) for t in tensors)


def as_numpy(x) -> np.ndarray:
    """A host numpy view of ``x``: tensors are copied off the card (an
    explicit ``.cpu()``), numpy arrays and array-likes pass through."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device``.  Tensors move (no copy when already
    there); numpy arrays are wrapped without a copy when writable and
    copied otherwise (memmaps and read-only blocks)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, copy=True, order="C")
    return torch.from_numpy(arr).to(device)
