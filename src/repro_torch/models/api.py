"""Public model API: specs and the functions that make the serve steps.

The step functions close over a model -- a :class:`~repro_torch.models.
transformer.DenseLM` or :class:`~repro_torch.models.transformer.HybridLM`,
which holds its parameters -- and take ``(caches, batch)`` with
``batch = {"tokens": [B, S]}``, where the reference's take
``(params, caches, batch)``.
"""

from __future__ import annotations

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


def model_specs(cfg: ModelConfig):
    return transformer.model_specs(cfg)


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
