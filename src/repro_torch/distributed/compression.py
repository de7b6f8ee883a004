"""Gradient compression for a cross-pod reduction.

int8 block quantization with error feedback: each leaf is quantized per
block of 256 values against its block max; the quantization residual is
carried in an error-feedback buffer and added back before the next round --
the standard trick that keeps compressed SGD/Adam convergence intact.

``compressed_psum`` is quantize -> all-reduce(int32) -> dequantize over a
``torch.distributed`` group; the wire format is 1 byte a value + 1 float32
scale a block (~4x less traffic than float32, ~2x less than bf16).  Every
operation is the reference's, in its order, so the results are its bits:
``torch.round`` rounds half to even as ``jnp.round`` does.
"""

from __future__ import annotations

import torch

Tree = dict

BLOCK = 256


def _pad_to_block(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), pad


def _over_127(block_max: torch.Tensor) -> torch.Tensor:
    # a divisor on the tensor's own device: CUDA multiplies by the
    # reciprocal of a host scalar divisor, which is not the quotient's bits
    return block_max / torch.full((), 127.0, dtype=torch.float32, device=block_max.device)


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    safe = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
    return q, safe


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (q [nb, BLOCK] int8, scales [nb] float32, pad)."""
    blocks, pad = _pad_to_block(x.to(torch.float32))
    scale = _over_127(torch.amax(torch.abs(blocks), dim=1))
    q, _ = _quantize(blocks, scale)
    return q, scale, pad


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, pad: int, shape) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def quantize_roundtrip(x: torch.Tensor) -> torch.Tensor:
    q, s, pad = quantize_int8(x)
    return dequantize_int8(q, s, pad, x.shape)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Quantized all-reduce (mean) over ``group`` (the default group when
    None); every rank gets the same float32 tensor.

    Participants first agree on a per-block scale (a MAX all-reduce of the
    tiny float32 block maxima), then quantize against the *shared* scale so
    the int8 payloads are summable (a SUM all-reduce of them as int32), and
    count themselves (a SUM all-reduce of a one) to divide by."""
    import torch.distributed as dist

    blocks, pad = _pad_to_block(x.to(torch.float32))
    local_max = torch.amax(torch.abs(blocks), dim=1)
    dist.all_reduce(local_max, op=dist.ReduceOp.MAX, group=group)
    scale = _over_127(local_max)
    q, safe = _quantize(blocks, scale)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    n = torch.ones((), dtype=torch.float32, device=x.device)
    dist.all_reduce(n, op=dist.ReduceOp.SUM, group=group)
    flat = (qsum.to(torch.float32) * safe[:, None]).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(x.shape) / n


def error_feedback_compress(grads: Tree, residual: Tree) -> tuple[Tree, Tree]:
    """(compressed grads, new residual): g' = Q(g + r); r' = (g + r) - g'."""
    from repro_torch.models.common import iter_leaves, set_leaf

    comp: Tree = {}
    resid: Tree = {}
    flat_r = dict(iter_leaves(residual))
    for path, g in iter_leaves(grads):
        g32 = g.to(torch.float32) + flat_r[path]
        gq = quantize_roundtrip(g32)
        set_leaf(comp, path, gq)
        set_leaf(resid, path, g32 - gq)
    return comp, resid


def init_residual(params: Tree) -> Tree:
    from repro_torch.models.common import iter_leaves, set_leaf

    out: Tree = {}
    for path, p in iter_leaves(params):
        set_leaf(out, path, torch.zeros(p.shape, dtype=torch.float32, device=p.device))
    return out


def compression_ratio(x_dtype=torch.float32) -> float:
    """Wire bytes ratio vs uncompressed (per BLOCK values)."""
    raw = BLOCK * torch.empty((), dtype=x_dtype).element_size()
    wire = BLOCK * 1 + 4
    return wire / raw
