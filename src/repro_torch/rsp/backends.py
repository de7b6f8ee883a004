"""Partition backend registry behind ``rsp.partition(..., backend=...)``.

Each backend runs Algorithm 1 (two-stage RSP partitioning) through a
different execution substrate and declares a *capability predicate* that
says whether it can serve a given request:

    np        -- the paper-faithful numpy path on the host, bit-identical to
                 the reference package's ``np`` backend; serves every array.
    np_stream -- the out-of-core single-pass scatter (``repro_torch.rsp.
                 ingest``), the reference's ``np_stream``: anything
                 ``as_chunk_source`` adapts (a memmapped ``.npy``, a directory
                 of chunk files, a record-batch iterator, an array) streams
                 to a stored RSP (``out=``) or an in-RAM assembly with
                 O(chunk) peak memory; bit-identical to ``np``.
    cuda      -- the ``rsp_shuffle`` kernel (the counterpart of the reference's
             ``pallas`` backend): one hierarchical tile shuffle per original
             block, all P blocks in one launch, with ``tile_rows = delta`` so
             the tile permutation *is* the sub-block dealing.  Needs 2-D
             floating-point data and ``permute_assignment``.  On a CPU device
             it runs the kernel's plain version, with the same bits.
    torch     -- Algorithm 1 in plain PyTorch (``core.partition.
             two_stage_partition_torch``; the counterpart of the reference's
             ``jax`` backend): any dtype (integer labels too), any
             ``[N, ...]`` trailing shape, ``permute_assignment=False``; the
             permutations come from a CPU ``torch.Generator`` seeded with
             ``spec.seed`` and the rows move in one gather on the request's
             device, so the card's blocks equal the CPU's.  No kernel.
    collective -- Algorithm 1 as one collective over a ``torch.distributed``
             gloo group (the counterpart of the reference's ``shard_map``):
             every rank of ``mesh`` calls ``rsp.partition`` with the whole
             corpus, randomizes its own original block on the
             ``rsp_shuffle`` kernel and exchanges sub-blocks with one
             ``all_to_all_single`` (``core.partition.
             distributed_rsp_partition``); each rank returns the whole
             ``[K, n, ...]`` after an ``all_gather``.  Needs P = K = D ranks
             and N divisible by D^2; bit-identical to ``cuda``.

``backend="auto"`` picks the highest ``auto_priority`` backend whose
predicates pass, with the reference package's choices: ``collective``
whenever a mesh is given; ``np_stream`` for
every input that must stream (paths, chunk directories, batch iterators,
memmaps -- the corpora that never fit in RAM) and for every ``out=`` write;
for in-memory arrays and tensors, ``cuda`` when the dataset's device is a
CUDA device and the data fit its predicates, ``np`` otherwise.  Backends
return the stacked RSP blocks ``[K, n, ...]`` as a tensor on the request's
device, or -- ``np_stream`` writing to ``out`` -- the finished
:class:`RSPStore`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.partition import (
    distributed_rsp_partition,
    exchange_refusal,
    two_stage_partition_np,
    two_stage_partition_torch,
)
from repro_torch.core.registry import RSPStore
from repro_torch.core.types import RSPSpec
from repro_torch.device import as_numpy, as_tensor
from repro_torch.kernels.rsp_shuffle.ops import rsp_randomize_blocks
from repro_torch.rsp.ingest import (
    is_stream_source,
    maybe_chunk_source,
    resolve_stream_source,
    stream_partition,
)

AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class PartitionRequest:
    """Everything a backend needs to decide eligibility and to run:
    ``data`` is a numpy array or tensor ``[N, ...]`` for the in-memory
    backends, or anything ``rsp.ingest.as_chunk_source`` adapts for
    ``np_stream``; the result lands on ``device``.  The streaming fields
    (``out``, ``with_summaries``, ``num_classes``, ``label_column``,
    ``chunk_records``) are read only by ``np_stream``: with ``out`` set its
    result is the finished :class:`RSPStore` (sketches folded during the
    write land in the manifest) instead of stacked blocks.  ``mesh`` (a
    ``torch.distributed.device_mesh.DeviceMesh``, whose dimension
    ``mesh_axis`` names the group, or a ``ProcessGroup``) is read only by
    ``collective``."""

    data: Any
    spec: RSPSpec
    device: torch.device
    permute_assignment: bool = True
    out: str | None = None
    with_summaries: bool = True
    num_classes: int | None = None
    label_column: int = -1
    chunk_records: int | None = None
    mesh: Any = None
    mesh_axis: str = "data"


@dataclasses.dataclass(frozen=True)
class PartitionBackend:
    """A named Algorithm-1 implementation with a capability predicate.

    ``supports`` returns ``None`` when the backend *can* serve the request
    and a human-readable refusal reason otherwise; it gates explicit
    ``backend=<name>`` dispatch.  ``auto_eligible`` (optional) adds a
    preference predicate consulted only by ``backend="auto"``.  ``run``
    returns the stacked RSP blocks [K, n, ...] on the request's device, or
    -- for a streaming backend writing to ``request.out`` -- the finished
    :class:`RSPStore`.
    """

    name: str
    capabilities: frozenset[str]
    supports: Callable[[PartitionRequest], str | None]
    run: Callable[[PartitionRequest], "torch.Tensor | RSPStore"]
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


def run_partition(
    request: PartitionRequest, backend: str = AUTO
) -> tuple["torch.Tensor | RSPStore", str]:
    """Dispatch a partition request; returns (result, backend name), the
    result being the stacked blocks [K, n, ...] or, for a streaming backend
    writing to ``request.out``, the finished :class:`RSPStore`."""
    if not isinstance(request.data, (np.ndarray, torch.Tensor)):
        # resolve a path/directory/iterator input to its ChunkSource ONCE:
        # every capability predicate and the eventual run then reuse it
        # instead of re-listing directories and re-reading .npy headers
        src = resolve_stream_source(request.data, chunk_records=request.chunk_records)
        if src is not None and src is not request.data:
            request = dataclasses.replace(request, data=src)
    b = select_backend(request) if backend == AUTO else get_backend(backend)
    if backend != AUTO:
        reason = b.supports(request)
        if reason is not None:
            raise ValueError(f"backend {b.name!r} cannot serve this request: {reason}")
    return b.run(request), b.name


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------

def _non_array_source(req: PartitionRequest) -> str | None:
    """Refusal reason the in-memory backends share: they can serve any
    array or tensor (memmaps included -- they materialize on use) but not a
    chunk-stream object, which only ``np_stream`` knows how to drain."""
    if not isinstance(req.data, (np.ndarray, torch.Tensor)) and is_stream_source(req.data):
        return "streaming ChunkSource input needs backend='np_stream'"
    return None


def _supports_np(req: PartitionRequest) -> str | None:
    # the host fallback serves every array the spec admits
    return _non_array_source(req)


def _run_np(req: PartitionRequest) -> torch.Tensor:
    blocks = two_stage_partition_np(
        as_numpy(req.data), req.spec, permute_assignment=req.permute_assignment
    )
    return as_tensor(blocks, req.device)


def _supports_torch(req: PartitionRequest) -> str | None:
    # in-memory arrays of any dtype and trailing shape; the spec's
    # divisibility is validated upstream
    return _non_array_source(req)


def _run_torch(req: PartitionRequest) -> torch.Tensor:
    generator = torch.Generator(device="cpu").manual_seed(req.spec.seed)
    return two_stage_partition_torch(
        as_tensor(req.data, req.device),
        generator,
        num_blocks=req.spec.num_blocks,
        num_original_blocks=req.spec.num_original_blocks,
        permute_assignment=req.permute_assignment,
    )


def _supports_np_stream(req: PartitionRequest) -> str | None:
    if maybe_chunk_source(req.data) is None:
        return (
            "input is not chunkable (need an array, a .npy path, a chunk-file"
            " directory, a batch sequence, or a ChunkSource)"
        )
    return None


def _auto_np_stream(req: PartitionRequest) -> str | None:
    # memmaps, paths, directories and ChunkSources always stream; in-RAM
    # arrays and tensors stream only for direct-to-store writes (out=);
    # everything else keeps the in-memory paths
    if is_stream_source(req.data):
        return None
    if req.out is not None and isinstance(req.data, (np.ndarray, torch.Tensor)):
        return None
    return "in-memory input without out= is served by the in-memory paths"


def _run_np_stream(req: PartitionRequest) -> "torch.Tensor | RSPStore":
    # without out= the facade gets stacked blocks back and computes
    # summaries the same way as every in-memory backend, so folding sketches
    # during the scatter would be duplicated work; with out= the folded
    # sketches ARE the store's manifest summaries (no second corpus scan)
    result, _ = stream_partition(
        req.data,
        req.spec,
        out=req.out,
        permute_assignment=req.permute_assignment,
        with_summaries=req.with_summaries and req.out is not None,
        num_classes=req.num_classes,
        label_column=req.label_column,
        chunk_records=req.chunk_records,
    )
    return result if isinstance(result, RSPStore) else as_tensor(result, req.device)


def _dtype_of(data) -> np.dtype | None:
    if isinstance(data, torch.Tensor):
        return torch.empty((), dtype=data.dtype).numpy().dtype
    dtype = getattr(data, "dtype", None)
    return None if dtype is None else np.dtype(dtype)


def _supports_cuda(req: PartitionRequest) -> str | None:
    reason = _non_array_source(req)
    if reason is not None:
        return reason
    shape = tuple(getattr(req.data, "shape", ()))
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
    if req.out is not None or is_stream_source(req.data):
        return "streaming inputs and out= writes are served by np_stream"
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


def _mesh_group(req: PartitionRequest):
    """``(group, None)`` for the request's mesh, or ``(None, reason)``."""
    mesh = req.mesh
    if mesh is None:
        return None, "requires a device mesh or process group (mesh=)"
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_available() or not dist.is_initialized():
        return None, "torch.distributed is not initialized"
    if isinstance(mesh, DeviceMesh):
        if req.mesh_axis not in (mesh.mesh_dim_names or ()):
            return None, f"mesh has no dimension {req.mesh_axis!r}"
        return mesh.get_group(req.mesh_axis), None
    if isinstance(mesh, dist.ProcessGroup):
        return mesh, None
    return None, f"mesh must be a DeviceMesh or a ProcessGroup, got {type(mesh).__name__}"


def _supports_collective(req: PartitionRequest) -> str | None:
    import torch.distributed as dist

    group, reason = _mesh_group(req)
    if reason is None:
        reason = exchange_refusal(group) or _supports_cuda(req)
    if reason is not None:
        return reason
    d = dist.get_world_size(group)
    if req.spec.num_blocks != d or req.spec.num_original_blocks != d:
        return (
            f"needs P = K = mesh size ({d}), got P={req.spec.num_original_blocks}"
            f" K={req.spec.num_blocks}"
        )
    if req.spec.num_records % (d * d) != 0:
        return f"N={req.spec.num_records} not divisible by mesh_size^2={d * d}"
    return None


def _run_collective(req: PartitionRequest) -> torch.Tensor:
    """Rank i's original block (rows ``[i*N/D, (i+1)*N/D)``) goes to the
    request's device and through :func:`distributed_rsp_partition`; the D
    RSP blocks are then gathered on every rank over the same group (host
    tensors, as gloo needs) and returned stacked on the device."""
    import torch.distributed as dist

    group, _ = _mesh_group(req)
    d, i = dist.get_world_size(group), dist.get_rank(group)
    n = req.spec.num_records // d
    block = distributed_rsp_partition(
        as_tensor(req.data[i * n:(i + 1) * n], req.device), req.spec.seed, group
    )
    host = block.cpu()
    blocks = [torch.empty_like(host) for _ in range(d)]
    dist.all_gather(blocks, host, group=group)
    return torch.stack(blocks).to(req.device)


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
        name="np_stream",
        capabilities=frozenset({"streaming", "out-of-core", "direct-to-store", "host"}),
        supports=_supports_np_stream,
        run=_run_np_stream,
        # above np: wins auto for everything chunkable unless auto_eligible
        # hands in-memory arrays without out= back to the in-memory paths
        auto_priority=25,
        auto_eligible=_auto_np_stream,
    )
)
register_backend(
    PartitionBackend(
        name="torch",
        capabilities=frozenset({"in-memory"}),
        supports=_supports_torch,
        run=_run_torch,
        auto_priority=10,
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
register_backend(
    PartitionBackend(
        name="collective",
        capabilities=frozenset({"in-memory", "collective", "mesh", "kernel"}),
        supports=_supports_collective,
        run=_run_collective,
        auto_priority=40,
    )
)
