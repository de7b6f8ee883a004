"""Device meshes: a ``torch.distributed`` ``DeviceMesh`` over the ranks that
exist, the reference's production shapes, and (re-exported from
``distributed.sharding``, whose type it is) the abstract mesh: axis names
and sizes, no process group, from which sharding rules are derived at any
size.

``make_production_mesh`` is a function (never a module-level constant), so
importing this module touches no process group or device.  The
reference's production layout is 256 accelerators a pod on ("data",
"model") = (16, 16), two pods over the data-centre network with "pod"
first.  The same axis names carry over; ``make_production_mesh`` builds the
mesh only when the world is that large (256 or 512 ranks, one a GPU) and
never shrinks it.  Smaller meshes (tests, one card) come from
``make_host_mesh``.

    init_process_group("nccl", ...)                 # or "gloo" on the host
    mesh = make_host_mesh((1, 1), ("data", "model"))
    rules = default_rules(mesh, cfg=cfg)            # distributed.sharding
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import dry_run

# the abstract mesh is a type of the sharding layer; re-exported beside the
# mesh builders
from repro_torch.distributed.sharding import AbstractMesh  # noqa: F401

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _world_size() -> int:
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed.init_process_group first"
                           " (gloo on the host, nccl on the card)")
    return dist.get_world_size()


def make_host_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
                   device_type: str = "cuda"):
    """A named ``DeviceMesh`` of ``shape`` over every rank of the process
    group (``init_device_mesh``), on ``device_type`` (``"cuda"`` unless
    ``"cpu"`` is asked for; gloo groups are CPU meshes; in a dry run,
    ``device.dry_run``, ``"cuda"`` needs no card).  Raises without a process
    group or when the mesh does not hold exactly the world's ranks."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    if device_type == "cuda" and not torch.cuda.is_available() and not dry_run():
        raise RuntimeError("device_type='cuda' was requested but no CUDA device is available;"
                           " pass device_type='cpu' for a gloo mesh on the host")
    n, world = math.prod(shape), _world_size()
    if n != world:
        raise ValueError(f"a {shape} mesh holds {n} ranks; the process group has {world}")
    with unset_fake_temporarily():      # the mesh's ranks are real values, in a dry run too
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh: (16, 16) on ("data", "model"), or
    (2, 16, 16) on ("pod", "data", "model") with ``multi_pod``.  The world
    must hold exactly that many ranks; it is never shrunk to fit."""
    shape, axes = ((MULTI_POD_SHAPE, MULTI_POD_AXES) if multi_pod
                   else (PRODUCTION_SHAPE, PRODUCTION_AXES))
    world = _world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs {math.prod(shape)} ranks; the"
                         f" process group has {world} (use make_host_mesh for smaller meshes)")
    return make_host_mesh(shape, axes, device_type=device_type)


# NVIDIA H100 SXM5 data-sheet figures (NVIDIA H100 80GB HBM3 at its 700 W
# power limit), one GPU; a card capped below 700 W runs slower under load
HBM_CAPACITY = 80 * 10**9       # device memory, bytes (the data sheet's 80 GB)
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core operations a second
PEAK_FLOPS_FP32 = 67e12         # float32 operations a second outside the tensor cores
HBM_BW = 3.35e12                # HBM3 bytes a second
NVLINK_BW = 900e9               # NVLink bytes a second a GPU (all links), within a node
# the network between nodes (NVIDIA DGX H100 data sheet: eight ConnectX-7
# ports of 400 Gb/s, one a GPU): 50e9 bytes a second a GPU.  Every 16-rank
# axis of the production mesh spans two 8-GPU nodes, so its collectives
# cross this network
NETWORK_BW = 50e9


def hbm_bytes(device=0) -> int:
    """The card's device memory, as ``torch.cuda.get_device_properties``
    reports it."""
    return int(torch.cuda.get_device_properties(device).total_memory)
