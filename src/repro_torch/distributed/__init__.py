"""``repro_torch.distributed`` -- model-state distribution (sharding rules
on a ``DeviceMesh``, ZeRO-1 shardings, the int8 compressed all-reduce) and
multi-host RSP: the transport, block ownership, straggler scheduling and
elastic re-deals.

The RSP query layer (``DistributedDataset``, ``DistributedQueryExecutor``)
resolves lazily via ``__getattr__``: it pulls in the whole
``repro_torch.rsp`` query stack, which a process that only deals blocks
need not pay for.  ``repro_torch.distributed.elastic`` holds the RSP churn
helpers and the model-state restore onto a mesh; import it directly.
"""

from repro_torch.distributed.sharding import (
    ShardingRules,
    activation_sharding,
    batch_shardings,
    block_ownership,
    constrain,
    default_rules,
    optimizer_shardings,
    param_shardings,
    zero_shard_spec,
)
from repro_torch.distributed.compression import (
    compressed_psum,
    compression_ratio,
    dequantize_int8,
    error_feedback_compress,
    init_residual,
    quantize_int8,
    quantize_roundtrip,
)
from repro_torch.distributed.mesh import (
    Heartbeat,
    HostKilledError,
    LocalTransport,
    TCPStoreTransport,
    Transport,
    TransportError,
    init_from_env,
    run_local_hosts,
    serve_store,
)
from repro_torch.distributed.ownership import (
    BlockOwnership,
    load_ownership,
    save_ownership,
)
from repro_torch.distributed.straggler import LeaseScheduler, simulate

__all__ = [k for k in dir() if not k.startswith("_")] + [
    "DistributedDataset",
    "DistributedQueryExecutor",
]

_LAZY = ("DistributedDataset", "DistributedQueryExecutor")


def __getattr__(name: str):
    if name in _LAZY:
        from repro_torch.distributed import rsp

        return getattr(rsp, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
