"""Batched serving engine: prefill, then KV-cache, SSM-state or RWKV-state
decode, for every model class (``DenseLM``, ``MoELM``, ``HybridLM``,
``RWKVLM``).
The caches are float32, as the reference's ``Server`` makes them: a
served RWKV6 pass shifts its tokens in float32 where a stateless one
shifts in bf16.

``EnsembleServer`` realises the paper's asymptotic-ensemble idea at serve
time: the log-probabilities of k models trained on disjoint RSP block
samples are averaged per decode step (the probability-averaging
combination of Sec. 9), ``logsumexp_i log_softmax(logits_i) - log k``.
It loops over its k models where the reference vmaps over stacked
parameters.

Greedy decoding (``temperature=0``) takes the first maximal logit, as
``jnp.argmax`` does.  Temperature sampling draws with ``torch.multinomial``
from a ``torch.Generator`` seeded with ``ServeConfig.seed``: deterministic
per seed, but not ``jax.random.categorical``'s bits.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


@dataclasses.dataclass
class ServeConfig:
    temperature: float = 0.0     # 0 = greedy
    seed: int = 0


def _on_device(cfg: ModelConfig, model: LM, device: torch.device) -> LM:
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name}, not {cfg.name}")
    return model.to(device)


def _prompts(prompts, device) -> torch.Tensor:
    t = prompts if isinstance(prompts, torch.Tensor) else torch.from_numpy(np.asarray(prompts))
    if t.ndim != 2:
        raise ValueError(f"prompts must be [B, P] token ids, got shape {tuple(t.shape)}")
    return t.to(device=device, dtype=torch.int64)


class _Clock:
    """Host seconds since construction, after the device has finished."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t0 = self.now()

    def now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def since(self) -> float:
        return self.now() - self.t0


class Server:
    """Serves one model (``DenseLM``, ``MoELM``, ``HybridLM`` or ``RWKVLM``) on
    ``device`` (the card unless ``"cpu"`` is asked for)."""

    def __init__(self, cfg: ModelConfig, model: LM, serve_cfg: ServeConfig | None = None,
                 *, device="cuda"):
        if cfg.family == "encoder":
            raise ValueError("encoder-only archs do not decode")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = _on_device(cfg, model, self.device)
        self.serve_cfg = serve_cfg or ServeConfig()
        self._prefill = api.make_prefill_fn(self.model)
        self._decode = api.make_decode_fn(self.model)
        self.last_stats: dict = {}

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.serve_cfg.temperature <= 0.0:
            return torch.argmax(logits[:, -1], dim=-1)
        probs = torch.softmax(logits[:, -1].to(torch.float32) / self.serve_cfg.temperature, -1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.no_grad()
    def generate(self, prompts, *, max_new_tokens: int, return_logits: bool = False):
        """prompts: [B, P] token ids -> int32 numpy [B, P + max_new_tokens];
        with ``return_logits`` also the float32 logits that chose each new
        token, [B, max_new_tokens, V].  ``last_stats`` holds the run's
        prefill, first-token and decode seconds (the device synchronised)."""
        tokens = _prompts(prompts, self.device)
        B, P = tokens.shape
        clock = _Clock(self.device)
        caches = transformer.init_caches(self.cfg, B, P + max_new_tokens, dtype=torch.float32,
                                         device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.serve_cfg.seed)
        logits, caches = self._prefill(caches, {"tokens": tokens})
        prefill_s = clock.since()
        tok = self._sample(logits, gen)
        first_token_s = clock.since()
        out, steps = [tokens], [logits[:, -1].to(torch.float32)] if return_logits else None
        for t in range(max_new_tokens):
            out.append(tok[:, None])
            if t == max_new_tokens - 1:
                break
            logits, caches = self._decode(caches, {"tokens": tok[:, None]})
            if return_logits:
                steps.append(logits[:, -1].to(torch.float32))
            tok = self._sample(logits, gen)
        result = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        total_s = clock.since()
        self.last_stats = {
            "batch": B, "prompt_len": P, "new_tokens": max_new_tokens,
            "prefill_s": prefill_s, "first_token_s": first_token_s,
            "decode_s": total_s - first_token_s, "total_s": total_s,
        }
        if return_logits:
            return result, torch.stack(steps, dim=1)
        return result


def ensemble_logprobs(logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """The Sec. 9 combination: ``logsumexp_i log_softmax(l_i) - log k``."""
    lp = torch.stack([torch.log_softmax(l.to(torch.float32), dim=-1) for l in logits])
    return torch.logsumexp(lp, dim=0) - math.log(len(logits))


class EnsembleServer:
    """Serves the average of k base models of one config (greedy)."""

    def __init__(self, cfg: ModelConfig, models: Sequence[LM],
                 serve_cfg: ServeConfig | None = None, *, device="cuda"):
        if cfg.family == "encoder":
            raise ValueError("encoder-only archs do not decode")
        if len(models) < 1:
            raise ValueError("an ensemble needs at least one model")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.models = [_on_device(cfg, m, self.device) for m in models]
        self.k = len(self.models)
        self.serve_cfg = serve_cfg or ServeConfig()
        self._prefill = [api.make_prefill_fn(m) for m in self.models]
        self._decode = [api.make_decode_fn(m) for m in self.models]
        self.last_stats: dict = {}

    @torch.no_grad()
    def generate(self, prompts, *, max_new_tokens: int):
        """prompts: [B, P] -> int32 numpy [B, P + max_new_tokens]."""
        tokens = _prompts(prompts, self.device)
        B, P = tokens.shape
        clock = _Clock(self.device)
        caches = [transformer.init_caches(self.cfg, B, P + max_new_tokens, dtype=torch.float32,
                                          device=self.device) for _ in range(self.k)]
        outs = [f(c, {"tokens": tokens}) for f, c in zip(self._prefill, caches)]
        caches = [c for _, c in outs]
        tok = torch.argmax(ensemble_logprobs([l for l, _ in outs])[:, -1], dim=-1)
        first_token_s = clock.since()
        out = [tokens]
        for t in range(max_new_tokens):
            out.append(tok[:, None])
            if t == max_new_tokens - 1:
                break
            outs = [f(c, {"tokens": tok[:, None]}) for f, c in zip(self._decode, caches)]
            caches = [c for _, c in outs]
            tok = torch.argmax(ensemble_logprobs([l for l, _ in outs])[:, -1], dim=-1)
        result = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        total_s = clock.since()
        self.last_stats = {
            "batch": B, "prompt_len": P, "new_tokens": max_new_tokens, "models": self.k,
            "first_token_s": first_token_s, "decode_s": total_s - first_token_s,
            "total_s": total_s,
        }
        return result
