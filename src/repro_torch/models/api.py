"""Public model API: specs and the functions that make the forward, loss
and serve steps.

The step functions close over a model -- a :class:`~repro_torch.models.
transformer.DenseLM`, :class:`~repro_torch.models.transformer.MoELM`,
:class:`~repro_torch.models.transformer.HybridLM` or
:class:`~repro_torch.models.transformer.RWKVLM`, which holds its
parameters.  For an MoE model the loss is ``ce + aux`` (the router's aux
loss summed over the layers), the stateless forward drops at the
configured capacity and the prefill and decode steps dispatch dropless,
as the reference's do.  The serve steps take ``(caches, batch)`` with ``batch =
{"tokens": [B, S]}``, where the reference's take ``(params, caches,
batch)``; the forward and the loss take ``(batch)`` where the reference's
take ``(params, batch)``.
"""

from __future__ import annotations

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


def model_specs(cfg: ModelConfig):
    return transformer.model_specs(cfg)


def make_loss_fn(model: LM):
    """The training loss: ``batch = {"tokens": [B, S + 1]}`` -> (loss,
    {"ce", "aux"})."""
    def f(batch):
        return transformer.loss_fn(model, batch)

    return f


def make_forward_fn(model: LM):
    """The stateless forward: ``batch = {"tokens": [B, S]}`` -> every
    position's logits [B, S, V] (bf16)."""
    def f(batch):
        logits, _, _ = transformer.forward_lm(model, batch["tokens"])
        return logits

    return f


def make_prefill_fn(model: LM):
    """Prefill: run the whole prompt, return (last-token logits [B, 1, V],
    caches).  Only the last position is unembedded: the reference computes
    every position's logits and keeps the last."""
    def f(caches, batch):
        h, new_caches = model.hidden(batch["tokens"], caches=caches)
        return model.logits(h[:, -1:]), new_caches

    return f


def make_decode_fn(model: LM):
    def f(caches, batch):
        return transformer.decode_step(model, caches, batch["tokens"])

    return f
