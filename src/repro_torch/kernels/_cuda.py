"""Build, load and call the port's CUDA kernels; count their launches.

The sources under ``repro_torch/csrc/`` are compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` -- one ``nvcc -c`` per
source, all started together, then one link -- into a shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a hash
of the sources and flags; a file lock and an atomic rename keep concurrent
processes from racing on the build.  Nothing here runs at import: the CPU
tests import every module on a machine with no ``nvcc`` and no card.

Every kernel wrapper checks its arguments, launches on
``torch.cuda.current_stream()``, raises if the C function returns a
non-zero ``cudaGetLastError()``, and adds one to its :class:`LaunchCounter`.

A launcher handed fake tensors (``torch._subclasses.fake_tensor``: shapes
and dtypes, no data, as a dry run traces one rank's program) launches
nothing: it returns empty outputs of the kernel's shapes and records the
launch, with the operations and bytes of the kernel's work function, in the
active dry run (:func:`record_shape_only`).  It builds no library and adds
nothing to a counter.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the exported functions: name -> (restype, argtypes)
_SIGNATURES = {
    "rsp_shuffle_launch": (_I, [_P, _P, _P, _P, _L, _L, _I, _I, _I, _I, _P]),
    "repro_cuda_error_string": (ctypes.c_char_p, [_I]),
    "repro_smem_optin": (_I, []),
    "sketch_scratch_bytes": (_L, [_I, _I, _I]),
    "block_sketch_smem_bytes": (_L, [_I, _I, _I, _I]),
    "block_sketch_max_clusters": (_I, [_I, _I, _I, _I]),
    "block_sketch_launch": (
        _I, [_P, _L, _I, _I, _L, _I, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P],
    ),
    "plan_sketch_smem_bytes": (_L, [_I, _I, _I, _I, _I, _I, _I]),
    "plan_sketch_max_clusters": (_I, [_I, _I, _I, _I, _I, _I, _I]),
    "plan_sketch_launch": (
        _I,
        [_P, _L, _I, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I,
         _P, _P, _I, _I, _P, _I, _P, _P, _P, _P],
    ),
    "flash_attention_smem_bytes": (_I, [_I]),
    "flash_attention_launch": (
        _I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, *([_L] * 12), _I, _F, _P],
    ),
    "flash_attention_bwd_launch": (
        _I, [*([_P] * 10), _I, _I, _I, _I, _I, _P, _I, _F, _P],
    ),
    "flash_attention_bwd_smem_bytes": (_I, [_I, _I]),
    "mamba2_ssd_launch": (_I, [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "mamba2_ssd_bwd_launch": (_I, [*([_P] * 12), _I, _I, _I, _I, _P]),
    "mamba2_ssd_bwd_smem_bytes": (_I, [_I]),
    "rwkv6_wkv_launch": (_I, [*([_P] * 9), _I, _I, _I, _P]),
    "rwkv6_wkv_bwd_launch": (_I, [*([_P] * 14), _I, _I, _I, _I, _P]),
    "rwkv6_wkv_bwd_smem_bytes": (_I, [_I]),
}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# the dry runs that record shape-only launches, innermost last
# (``launch.roofline.DryRunRecorder`` pushes itself while it is active)
_DRY_RUNS: list = []


class LaunchCounter:
    """A thread-safe count of kernel launches, for showing that a run went
    through a kernel.  Wrappers call :meth:`add` exactly where they launch,
    optionally with a record of the launch (the path it took, its grid),
    which :attr:`last` keeps."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0
        self.last: dict = {}

    def add(self, record: dict | None = None) -> None:
        with self._lock:
            self._n += 1
            if record is not None:
                self.last = record

    @property
    def value(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of every source and header plus the compiler flags."""
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA"
        " kernels are built from source at first use on a machine with the"
        " CUDA toolkit"
    )


def _compile(out_dir: Path) -> tuple[Path, str]:
    """Compile every source in parallel, link, return (library, log)."""
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append(
            (src.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        )
    log, failed = [], []
    for name, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    lib = out_dir / LIB_NAME
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    log.append(f"== link\n{link.stdout}")
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    return lib, "\n".join(log)


def build() -> Path:
    """Build the kernel library if this source hash has none yet; returns its
    path.  Safe across processes (file lock + atomic rename)."""
    key = source_hash()
    final_dir = BUILD_ROOT / key
    lib = final_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / f"{key}.lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            if lib.exists():  # another process finished while we waited
                return lib
            tmp = Path(tempfile.mkdtemp(prefix=f"{key}.", dir=BUILD_ROOT))
            try:
                built, log = _compile(tmp)
                (tmp / "build.log").write_text(log)
                final_dir.mkdir(exist_ok=True)
                os.replace(tmp / "build.log", final_dir / "build.log")
                os.replace(built, lib)  # the library appears atomically
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return lib


def build_log() -> str:
    """The compiler's output (``-Xptxas -v`` register and shared-memory
    report) of the current build, or '' before the first build."""
    path = BUILD_ROOT / source_hash() / "build.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _LIB = lib
        return _LIB


def check(code: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        msg = library().repro_cuda_error_string(code)
        raise RuntimeError(
            f"{what} failed: CUDA error {code} ({msg.decode() if msg else 'unknown'})"
        )


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of the current stream on ``device`` (a CUDA
    tensor's device), through PyTorch's own accessor of CUDA builds, which
    makes no ``torch.cuda.Stream`` object on every call."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def require_same_device(device: torch.device, **tensors: torch.Tensor) -> None:
    """Raise unless every named tensor lies on ``device``, the block's: a
    kernel handed a pointer into another device's memory faults or reads
    the wrong card."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, but the block is on {device}")


def refuse_graph(what: str, instead: str, **tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` when grad mode is on and a named tensor requires
    grad: a raw launcher hands back outputs with no ``grad_fn``, and every
    gradient upstream of it would silently be dropped; ``instead`` names
    the function that carries the gradient."""
    if torch.is_grad_enabled():
        wanted = [name for name, t in tensors.items() if t is not None and t.requires_grad]
        if wanted:
            raise ValueError(f"{what} returns no gradient ({', '.join(wanted)} require grad):"
                             f" differentiate through {instead}")


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device pointer, or None (a null pointer) for no tensor."""
    return None if t is None else t.data_ptr()


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype | None = None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor (of ``dtype``)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the CUDA kernel")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def is_fake(t: torch.Tensor | None) -> bool:
    """Whether ``t`` is a fake tensor (shapes and dtypes, no data)."""
    from torch._subclasses.fake_tensor import is_fake as _is_fake

    return t is not None and _is_fake(t)


def record_shape_only(name: str, ops: int, nbytes: int, dtype: str) -> None:
    """One shape-only launch of kernel ``name``: ``ops`` operations in
    ``dtype`` ("bf16" on the tensor cores, "f32" at the float32 rate) and
    ``nbytes`` of device memory moved, recorded in the innermost active dry
    run (none active: nothing is recorded)."""
    if _DRY_RUNS:
        _DRY_RUNS[-1].record_kernel(name, int(ops), int(nbytes), dtype)
