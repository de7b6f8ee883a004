"""The dense decoder LM (llama / qwen / granite / chameleon backbones) as
``nn.Module``s: embedding, a ``ModuleList`` of pre-norm layers (attention +
SwiGLU or GELU MLP), final RMS norm and a (tied or separate) unembedding.

Parameters are float32 and laid out as the reference lays them out, so a
reference parameter tree -- numpy arrays, layers stacked on the leading
axis as ``model_specs`` gives them -- loads as it is
(``DenseLM(cfg, params=tree)``), and fresh weights are drawn at the
reference's scales from an explicit ``torch.Generator``.

Decode caches are ``{"layers": {"k", "v": [L, B, Hkv, T, D], "length": int},
"pos": int}``: the reference's stacked layout, with one length for all
layers.  They are updated in place.

The MoE, hybrid (zamba2), RWKV and encoder families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import ffn
from repro_torch.models.common import (
    Params,
    Tree,
    embed,
    embedding_spec,
    init_params,
    iter_leaves,
    rmsnorm,
    rmsnorm_spec,
    set_leaf,
    stack_specs,
    unembed_logits,
)
from repro_torch.models.config import ModelConfig

NOT_PORTED = {
    "moe": "the MoE family (router and dispatch) waits for ROADMAP section 1, item 9",
    "hybrid": "the zamba2 hybrid (mamba2 + mamba2_ssd) waits for ROADMAP section 1, item 1",
    "rwkv": "the RWKV6 family (rwkv6_wkv) waits for ROADMAP section 1, item 2",
    "encoder": "the encoder family (hubert) waits for ROADMAP section 1, item 10",
}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        if cfg.family in NOT_PORTED:
            raise NotImplementedError(f"{cfg.name}: {NOT_PORTED[cfg.family]}")
        raise ValueError(f"unknown family {cfg.family}")


# ===========================================================================
# Parameter specs
# ===========================================================================

def _dense_layer_specs(cfg: ModelConfig) -> Tree:
    specs = {
        "norm1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attention_specs(cfg.attention_config()),
        "norm2": rmsnorm_spec(cfg.d_model),
    }
    if cfg.mlp_type == "gelu":
        specs["mlp"] = ffn.gelu_mlp_specs(cfg.d_model, cfg.d_ff, bias=False)
    else:
        specs["mlp"] = ffn.swiglu_specs(cfg.d_model, cfg.d_ff)
    return specs


def model_specs(cfg: ModelConfig) -> Tree:
    _require_dense(cfg)
    specs: Tree = {
        "embed": embedding_spec(cfg.vocab_size, cfg.d_model),
        "layers": stack_specs(_dense_layer_specs(cfg), cfg.num_layers),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        specs["unembed"] = embedding_spec(cfg.vocab_size, cfg.d_model)
    return specs


def params_to_tensors(specs: Tree, tree: Tree, device) -> Tree:
    """A parameter tree (numpy arrays or tensors, any float dtype) as
    float32 tensors on ``device``, checked leaf by leaf against the specs."""
    got = {path for path, _ in iter_leaves(tree)}
    out: Tree = {}
    for path, spec in iter_leaves(specs):
        if path not in got:
            raise KeyError(f"parameter tree misses {'/'.join(path)}")
        leaf = tree
        for name in path:
            leaf = leaf[name]
        if not isinstance(leaf, torch.Tensor):
            arr = np.asarray(leaf)
            leaf = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        if tuple(leaf.shape) != spec.shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(leaf.shape)} != {spec.shape}")
        set_leaf(out, path, leaf.to(device=device, dtype=torch.float32))
    extra = got - {path for path, _ in iter_leaves(specs)}
    if extra:
        raise KeyError(f"parameter tree has leaves the model lacks: {sorted(extra)}")
    return out


def _layer_tree(stacked: Tree, i: int) -> Tree:
    out: Tree = {}
    for path, leaf in iter_leaves(stacked):
        set_leaf(out, path, leaf[i])
    return out


# ===========================================================================
# Modules
# ===========================================================================

class DenseLayer(nn.Module):
    """Pre-norm decoder layer: h + attn(norm1(h)), then + mlp(norm2(h))."""

    def __init__(self, cfg: ModelConfig, params: Tree):
        super().__init__()
        self.cfg = cfg
        self.acfg = cfg.attention_config()
        self.norm1 = Params(params["norm1"])
        self.attn = Params(params["attn"])
        self.norm2 = Params(params["norm2"])
        self.mlp = Params(params["mlp"])

    def forward(self, h, positions, cache=None, *, attn_impl: str = "auto"):
        a_in = rmsnorm(self.norm1, h, eps=self.cfg.norm_eps)
        a_out, new_cache = attn.attention_apply(
            self.attn, a_in, self.acfg, positions=positions, cache=cache, impl=attn_impl)
        h = h + a_out
        f_in = rmsnorm(self.norm2, h, eps=self.cfg.norm_eps)
        if self.cfg.mlp_type == "gelu":
            f_out = ffn.gelu_mlp_apply(self.mlp, f_in)
        else:
            f_out = ffn.swiglu_apply(self.mlp, f_in)
        return h + f_out, new_cache


class DenseLM(nn.Module):
    """A dense decoder LM on ``device`` (the card unless ``"cpu"`` is asked
    for).  ``params`` is a reference-layout tree (numpy arrays or tensors);
    without it the weights are drawn from ``torch.Generator(device)`` seeded
    with ``seed``, at the reference's scales."""

    def __init__(self, cfg: ModelConfig, params: Tree | None = None, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        specs = model_specs(cfg)
        dev = resolve_device(device)
        if params is None:
            params = init_params(specs, torch.Generator(device=dev).manual_seed(seed), dev)
        else:
            params = params_to_tensors(specs, params, dev)
        self.cfg = cfg
        self.embed = Params(params["embed"])
        self.layers = nn.ModuleList(
            DenseLayer(cfg, _layer_tree(params["layers"], i)) for i in range(cfg.num_layers))
        self.final_norm = Params(params["final_norm"])
        self.unembed = None if cfg.tie_embeddings else Params(params["unembed"])

    def hidden(self, tokens: torch.Tensor, *, caches: Any = None, attn_impl: str = "auto"):
        """Final-normed hidden states [B, S, d] (bf16) and the new caches."""
        h = embed(self.embed, tokens)
        S = tokens.shape[1]
        pos0 = caches["pos"] if caches is not None else 0
        positions = torch.arange(S, device=tokens.device) + pos0
        length = None
        for i, layer in enumerate(self.layers):
            cache = None
            if caches is not None:
                lc = caches["layers"]
                cache = {"k": lc["k"][i], "v": lc["v"][i], "length": lc["length"]}
            h, new_cache = layer(h, positions, cache, attn_impl=attn_impl)
            if new_cache is not None:
                length = new_cache["length"]
        h = rmsnorm(self.final_norm, h, eps=self.cfg.norm_eps)
        new_caches = None
        if caches is not None:
            layers = dict(caches["layers"], length=length)
            new_caches = {"layers": layers, "pos": pos0 + S}
        return h, new_caches

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        table = self.embed if self.cfg.tie_embeddings else self.unembed
        return unembed_logits(table, h)

    def forward(self, tokens: torch.Tensor, *, caches: Any = None):
        h, new_caches = self.hidden(tokens, caches=caches)
        return self.logits(h), new_caches


# ===========================================================================
# Top-level forward / decode (the reference's function names)
# ===========================================================================

def forward_lm(model: DenseLM, tokens: torch.Tensor, *, caches: Any = None):
    """Returns (logits [B, S, vocab] bf16, new_caches, aux loss 0)."""
    logits, new_caches = model(tokens, caches=caches)
    return logits, new_caches, torch.zeros((), dtype=torch.float32, device=tokens.device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Every layer's ``attention.init_cache``, stacked on a leading axis."""
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
    return {
        "layers": {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "length": 0,
        },
        "pos": 0,
    }


def decode_step(model: DenseLM, caches, tokens: torch.Tensor):
    """One serve step: tokens [B, 1] -> (logits [B, 1, V], new_caches)."""
    logits, new_caches = model(tokens, caches=caches)
    return logits, new_caches
