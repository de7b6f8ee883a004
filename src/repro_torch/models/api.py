"""Public model API: specs, inputs per shape cell, and the functions that
make the forward, loss and serve steps.

The step functions close over a model -- a :class:`~repro_torch.models.
transformer.DenseLM`, :class:`~repro_torch.models.transformer.MoELM`,
:class:`~repro_torch.models.transformer.HybridLM`,
:class:`~repro_torch.models.transformer.RWKVLM` or
:class:`~repro_torch.models.transformer.EncoderModel`, which holds its
parameters.  The encoder's forward takes ``{"frames"}``, its loss
``{"frames", "targets", "mask"}``, and its prefill returns ``(logits,
None)``: it has no caches and no decode.  For an MoE model the loss is ``ce + aux`` (the router's aux
loss summed over the layers), the stateless forward drops at the
configured capacity and the prefill and decode steps dispatch dropless,
as the reference's do.  The serve steps take ``(caches, batch)`` with ``batch =
{"tokens": [B, S]}``, where the reference's take ``(params, caches,
batch)``; the forward and the loss take ``(batch)`` where the reference's
take ``(params, batch)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.shapes import ShapeCell
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, Model


def model_specs(cfg: ModelConfig):
    return transformer.model_specs(cfg)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one model input (nothing allocated)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict[str, TensorSpec]:
    """Model inputs for one shape cell, in the reference's order:

    train (LM):    tokens [B, S+1]  (loss predicts S positions)
    train (enc):   frames [B, S, d] bf16, targets [B, S], mask [B, S] bool
    prefill:       tokens [B, S]  (encoder: frames [B, S, d])
    decode:        tokens [B, 1]  (no encoder decode)
    """
    B, S = cell.global_batch, cell.seq_len
    if cfg.family == "encoder":
        if cell.kind == "train":
            return {"frames": TensorSpec((B, S, cfg.d_model), torch.bfloat16),
                    "targets": TensorSpec((B, S), torch.int32),
                    "mask": TensorSpec((B, S), torch.bool)}
        if cell.kind == "prefill":
            return {"frames": TensorSpec((B, S, cfg.d_model), torch.bfloat16)}
        raise ValueError("encoder-only arch has no decode inputs")
    if cell.kind == "train":
        return {"tokens": TensorSpec((B, S + 1), torch.int32)}
    if cell.kind == "prefill":
        return {"tokens": TensorSpec((B, S), torch.int32)}
    return {"tokens": TensorSpec((B, 1), torch.int32)}


def concrete_inputs(cfg: ModelConfig, cell: ShapeCell, seed: int = 0, *,
                    device="cuda") -> dict[str, torch.Tensor]:
    """Real inputs matching :func:`input_specs`, drawn from
    ``numpy.random.default_rng(seed)`` in the reference's order, so both
    packages get the same values: ids below the vocab (2 for other ints),
    a mask true with probability 0.3, normal floats cast to the dtype."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)
    out: dict[str, torch.Tensor] = {}
    for k, s in input_specs(cfg, cell).items():
        if s.dtype == torch.int32:
            hi = cfg.vocab_size if k in ("tokens", "targets") else 2
            arr = torch.from_numpy(rng.integers(0, hi, size=s.shape, dtype=np.int32))
        elif s.dtype == torch.bool:
            arr = torch.from_numpy(rng.random(s.shape) < 0.3)
        else:
            arr = torch.from_numpy(rng.normal(size=s.shape).astype(np.float32)).to(s.dtype)
        out[k] = arr.to(dev)
    return out


def make_loss_fn(model: Model, moe_groups: int = 1):
    """The training loss: ``batch = {"tokens": [B, S + 1]}`` (the
    encoder's: ``{"frames", "targets", "mask"}``) -> (loss, {"ce", "aux"});
    an MoE model dispatches its tokens in ``moe_groups`` groups."""
    def f(batch):
        return transformer.loss_fn(model, batch, moe_groups=moe_groups)

    return f


def make_forward_fn(model: Model):
    """The stateless forward: ``batch = {"tokens": [B, S]}`` (the
    encoder's: ``{"frames": [B, S, d]}``) -> every position's logits [B, S,
    V] (bf16)."""
    if model.cfg.family == "encoder":
        def f(batch):
            return transformer.forward_encoder(model, batch["frames"])

        return f

    def f(batch):
        logits, _, _ = transformer.forward_lm(model, batch["tokens"])
        return logits

    return f


def make_prefill_fn(model: Model):
    """Prefill: run the whole prompt, return (last-token logits [B, 1, V],
    caches).  Only the last position is unembedded: the reference computes
    every position's logits and keeps the last.  The encoder's takes
    ``batch`` alone and returns (every position's logits, None)."""
    if model.cfg.family == "encoder":
        def f(batch):
            return transformer.forward_encoder(model, batch["frames"]), None

        return f

    def f(caches, batch):
        h, new_caches = model.hidden(batch["tokens"], caches=caches)
        return model.logits(h[:, -1:]), new_caches

    return f


def make_decode_fn(model: LM):
    def f(caches, batch):
        return transformer.decode_step(model, caches, batch["tokens"])

    return f
