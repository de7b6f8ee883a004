"""Partition backend registry behind ``rsp.partition(..., backend=...)``.

Each backend runs Algorithm 1 (two-stage RSP partitioning) through a
different execution substrate and declares a *capability predicate* that
says whether it can serve a given request:

    np    -- the paper-faithful numpy path on the host, bit-identical to the
             reference package's ``np`` backend; serves every array.
    cuda  -- the ``rsp_shuffle`` kernel (the counterpart of the reference's
             ``pallas`` backend): one hierarchical tile shuffle per original
             block, all P blocks in one launch, with ``tile_rows = delta`` so
             the tile permutation *is* the sub-block dealing.  Needs 2-D
             floating-point data and ``permute_assignment``.  On a CPU device
             it runs the kernel's plain version, with the same bits.

``backend="auto"`` picks the highest ``auto_priority`` backend whose
predicates pass: ``cuda`` when the dataset's device is a CUDA device and the
data fit its predicates, ``np`` otherwise.  Backends return the stacked RSP
blocks ``[K, n, ...]`` as a tensor on the request's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.partition import two_stage_partition_np
from repro_torch.core.types import RSPSpec
from repro_torch.device import as_numpy, as_tensor
from repro_torch.kernels.rsp_shuffle.ops import rsp_randomize_blocks

AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class PartitionRequest:
    """Everything a backend needs to decide eligibility and to run:
    ``data`` is a numpy array or tensor ``[N, ...]``; the result lands on
    ``device``."""

    data: Any
    spec: RSPSpec
    device: torch.device
    permute_assignment: bool = True


@dataclasses.dataclass(frozen=True)
class PartitionBackend:
    """A named Algorithm-1 implementation with a capability predicate.

    ``supports`` returns ``None`` when the backend *can* serve the request
    and a human-readable refusal reason otherwise; it gates explicit
    ``backend=<name>`` dispatch.  ``auto_eligible`` (optional) adds a
    preference predicate consulted only by ``backend="auto"``.  ``run``
    returns the stacked RSP blocks [K, n, ...] on the request's device.
    """

    name: str
    capabilities: frozenset[str]
    supports: Callable[[PartitionRequest], str | None]
    run: Callable[[PartitionRequest], torch.Tensor]
    auto_priority: int
    auto_eligible: Callable[[PartitionRequest], str | None] | None = None


_REGISTRY: dict[str, PartitionBackend] = {}


def register_backend(backend: PartitionBackend) -> PartitionBackend:
    if backend.name == AUTO:
        raise ValueError(f"'{AUTO}' is reserved for automatic selection")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> PartitionBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {available_backends()}"
        ) from None


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def backend_eligibility(request: PartitionRequest) -> dict[str, str | None]:
    """Map backend name -> None (eligible) or the refusal reason."""
    return {name: b.supports(request) for name, b in _REGISTRY.items()}


def select_backend(request: PartitionRequest) -> PartitionBackend:
    """The ``backend="auto"`` rule: highest-priority eligible backend."""
    ranked = sorted(_REGISTRY.values(), key=lambda b: -b.auto_priority)
    reasons: list[str] = []
    for b in ranked:
        reason = b.supports(request)
        if reason is None and b.auto_eligible is not None:
            reason = b.auto_eligible(request)
        if reason is None:
            return b
        reasons.append(f"{b.name}: {reason}")
    raise ValueError("no backend can serve this request; " + "; ".join(reasons))


def run_partition(request: PartitionRequest, backend: str = AUTO) -> tuple[torch.Tensor, str]:
    """Dispatch a partition request; returns (stacked blocks, backend name)."""
    b = select_backend(request) if backend == AUTO else get_backend(backend)
    if backend != AUTO:
        reason = b.supports(request)
        if reason is not None:
            raise ValueError(f"backend {b.name!r} cannot serve this request: {reason}")
    return b.run(request), b.name


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------

def _supports_np(req: PartitionRequest) -> str | None:
    return None  # the host fallback serves every array the spec admits


def _run_np(req: PartitionRequest) -> torch.Tensor:
    blocks = two_stage_partition_np(
        as_numpy(req.data), req.spec, permute_assignment=req.permute_assignment
    )
    return as_tensor(blocks, req.device)


def _dtype_of(data) -> np.dtype | None:
    if isinstance(data, torch.Tensor):
        return torch.empty((), dtype=data.dtype).numpy().dtype
    dtype = getattr(data, "dtype", None)
    return None if dtype is None else np.dtype(dtype)


def _supports_cuda(req: PartitionRequest) -> str | None:
    shape = tuple(req.data.shape)
    if len(shape) != 2:
        return f"kernel needs 2-D [records, features] data, got shape {shape}"
    dtype = _dtype_of(req.data)
    if dtype is None or not np.issubdtype(dtype, np.floating):
        return f"the cuda backend partitions float data, got {dtype}"
    if not req.permute_assignment:
        return "sub-block assignment permutation is intrinsic to the tile dealing"
    if req.spec.num_original_blocks > 65535:
        return "the kernel takes at most 65535 original blocks per launch"
    return None


def _auto_cuda(req: PartitionRequest) -> str | None:
    if req.device.type != "cuda":
        return "the dataset's device is not a CUDA device"
    return None


def _run_cuda(req: PartitionRequest) -> torch.Tensor:
    """Algorithm 1 with the randomize step on the ``rsp_shuffle`` kernel.

    Per original block, ``tile_rows = delta`` makes the tile permutation be
    the sub-block dealing: output tile k of block i is the (intra-shuffled)
    sub-block destined for RSP block k.  The permutations are drawn on the
    host (``kernels.rsp_shuffle.ops``); the kernel shuffles all P original
    blocks in one launch, and the stack ``[P, K, delta, F]`` is transposed
    into ``[K, P*delta, F]`` on the device.
    """
    spec = req.spec
    P, K, delta = spec.num_original_blocks, spec.num_blocks, spec.slice_size
    x = as_tensor(req.data, req.device)
    if not x.is_contiguous():
        x = x.contiguous()
    R, F = spec.original_block_size, x.shape[1]
    sub = rsp_randomize_blocks(x.reshape(P, R, F), spec.seed, tile_rows=delta)
    return sub.reshape(P, K, delta, F).transpose(0, 1).reshape(K, P * delta, F)


register_backend(
    PartitionBackend(
        name="np",
        capabilities=frozenset({"in-memory", "host"}),
        supports=_supports_np,
        run=_run_np,
        auto_priority=20,
    )
)
register_backend(
    PartitionBackend(
        name="cuda",
        capabilities=frozenset({"in-memory", "kernel"}),
        supports=_supports_cuda,
        run=_run_cuda,
        auto_priority=30,
        auto_eligible=_auto_cuda,
    )
)
