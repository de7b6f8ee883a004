"""``repro_torch`` -- the RSP data model on PyTorch and CUDA.

A port of ``repro`` (JAX on a TPU) to one NVIDIA H100, with the same
layout: ``core`` (spec, Algorithm 1, store, sampler, estimators),
``kernels`` (hand-written CUDA C++ for ``sm_90a`` under ``csrc/``, each
beside its plain PyTorch version), ``rsp`` (the pipeline facade, engine and
progressive queries), ``obs`` (telemetry) and ``data`` (synthetic corpora).
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.  The package imports ``torch`` and numpy only.
"""

from repro_torch.device import as_numpy, as_tensor, resolve_device

__all__ = ["as_numpy", "as_tensor", "resolve_device"]
