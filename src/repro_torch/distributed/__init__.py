"""``repro_torch.distributed`` -- multi-host RSP: the transport, block
ownership, straggler scheduling and elastic re-deals.

The RSP query layer (``DistributedDataset``, ``DistributedQueryExecutor``)
resolves lazily via ``__getattr__``: it pulls in the whole
``repro_torch.rsp`` query stack, which a process that only deals blocks
need not pay for.  ``repro_torch.distributed.elastic`` holds the RSP churn
helpers; import it directly.
"""

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
