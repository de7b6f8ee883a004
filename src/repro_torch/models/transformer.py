"""The decoder LMs and the encoder as ``nn.Module``s.

* :class:`DenseLM` (llama / qwen / granite / chameleon backbones):
  embedding, a ``ModuleList`` of pre-norm layers (attention + SwiGLU or GELU
  MLP), final RMS norm and a (tied or separate) unembedding.
* :class:`MoELM` (granite-moe / qwen3-moe): the dense decoder with a
  Mixture-of-Experts layer (``models/moe.py``) in place of every MLP;
  ``forward_lm`` returns the router aux loss summed over the layers, and a
  pass with caches (prefill and decode) dispatches dropless.
* :class:`HybridLM` (zamba2): embedding, then rounds of one invocation of
  the single shared transformer block -- applied to ``concat(embedding,
  hidden)`` -- followed by ``attn_every`` pre-norm Mamba2 layers, an
  epilogue round for the remainder (81 = 13 * 6 + 3), the final RMS norm
  and the unembedding.
* :class:`RWKVLM` (rwkv6): embedding, an input layer norm, a ``ModuleList``
  of RWKV6 layers (layer norm, time mix, residual; layer norm, channel mix,
  residual), an output layer norm and the separate unembedding.
* :class:`EncoderModel` (hubert): an input projection of precomputed frame
  embeddings (the waveform frontend is a stub, as in the reference), a
  convolutional positional embedding (every 16th of its 128 taps, the
  input padded by 64 before and 63 after, each tap's product and sum
  rounded to bf16 in the reference's order, then GELU), an input layer
  norm, a ``ModuleList`` of pre-norm encoder layers (layer norm,
  non-causal attention without RoPE, residual; layer norm, GELU MLP with
  bias, residual), an output layer norm and a linear head with bias.

Parameters are float32 and laid out as the reference lays them out, so a
reference parameter tree -- numpy arrays, layers stacked on the leading
axis as ``model_specs`` gives them (the hybrid's ``rounds`` twice,
``[rounds, attn_every, ...]``, its ``epilogue`` once) -- loads as it is
(``DenseLM(cfg, params=tree)``, ``HybridLM(cfg, params=tree)``,
``RWKVLM(cfg, params=tree)``), and fresh
weights are drawn at the reference's scales from an explicit
``torch.Generator``.

Activations are bf16 between layers.  Where a bf16 sum feeds both a norm
and the residual stream (attention's output added in, before the MLP's
norm), the norm reads the float32 sum and the residual its bf16 rounding:
the reference's layers, jitted by XLA on the host, drop the bf16 round
trip in front of the norm's float32 cast and keep it on the residual path,
and the port follows that to the bit.  The RWKV6 layer's residual sum
after the time mix feeds the channel mix's layer norm the same way.

Decode caches are updated in place.  Dense: ``{"layers": {"k", "v": [L, B,
Hkv, T, D], "length": int}, "pos": int}``, the reference's stacked layout
with one length for all layers.  Hybrid: ``{"layers": {"attn": {"k", "v":
[invocations, B, Hkv, T, D], "length": int}, "mamba": {"conv": [L, B, K-1,
Ch], "ssm": [L, B, H, P, N]}}, "pos": int}``: one KV cache per invocation
of the shared block, one state per Mamba2 layer.  RWKV6: ``{"layers":
{"time": {"shift": [L, B, 1, d], "wkv": [L, B, H, C, C]}, "channel":
{"shift": [L, B, 1, d]}}, "pos": int}``; the channel mix's shift comes back
in the activations' dtype (bf16), as the reference's does, so a float32
one is replaced by a bf16 copy at the first pass.

Training (every family; each kernel on the path has a backward: flash
attention's, the SSD's and the WKV's): built with
``trainable=True`` a model takes the leaves of a reference-layout tree as
they are -- the training state's bf16 parameters, no copy and no cast; a
layer's parameters are views of the stacked leaves -- and every parameter
requires grad.  zamba2's shared block is one set of parameters called
before every round, so its gradient sums over the calls.  With
``cfg.remat`` each layer of a pass that builds a graph (and each call of
the shared block) runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` around the scanned layer or round body), so its
activations are recomputed in the backward and its forward kernels run
twice.  ``stacks`` names each stacked leaf's layer modules, in the
layout, for ``train.param_grads``.  ``lm_loss`` takes ``tokens [B, S +
1]`` (and ``moe_groups``, the MoE layers' dispatch groups) and, with
``cfg.loss_seq_chunks``, streams the cross entropy over sequence chunks
from the final hidden states (``_backbone_hidden``); ``encoder_loss`` takes
``frames [B, T, d]``, ``targets`` and ``mask [B, T]``; ``loss_fn`` picks by
family.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn
from repro_torch.models import ffn, mamba2, rwkv6
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    Params,
    ParamSpec,
    Tree,
    embed,
    embedding_spec,
    init_params,
    iter_leaves,
    layernorm,
    layernorm_spec,
    linear,
    linear_spec,
    rmsnorm,
    rmsnorm_spec,
    seq_chunked_cross_entropy,
    set_leaf,
    softmax_cross_entropy,
    stack_specs,
    unembed_logits,
)
from repro_torch.models.config import ModelConfig


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in MODELS:
        raise ValueError(f"unknown family {cfg.family}")


def _require_class(cfg: ModelConfig, cls: type) -> None:
    _require_ported(cfg)
    if MODELS[cfg.family] is not cls:
        raise ValueError(f"{cfg.name}: the {cfg.family} family is built by"
                         f" {MODELS[cfg.family].__name__}, not {cls.__name__} (build_lm picks it)")


# ===========================================================================
# Parameter specs
# ===========================================================================

def _dense_layer_specs(cfg: ModelConfig) -> Tree:
    specs = {
        "norm1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attention_specs(cfg.attention_config()),
        "norm2": rmsnorm_spec(cfg.d_model),
    }
    if cfg.family == "moe":
        specs["moe"] = moe_lib.moe_specs(cfg.moe_config())
    elif cfg.mlp_type == "gelu":
        specs["mlp"] = ffn.gelu_mlp_specs(cfg.d_model, cfg.d_ff, bias=False)
    else:
        specs["mlp"] = ffn.swiglu_specs(cfg.d_model, cfg.d_ff)
    return specs


def _shared_block_specs(cfg: ModelConfig) -> Tree:
    return {
        "in_proj": linear_spec(2 * cfg.d_model, cfg.d_model, (None, "embed")),
        "norm1": rmsnorm_spec(cfg.d_model),
        "attn": attn.attention_specs(cfg.attention_config()),
        "norm2": rmsnorm_spec(cfg.d_model),
        "mlp": ffn.swiglu_specs(cfg.d_model, cfg.d_ff),
    }


def _mamba_layer_specs(cfg: ModelConfig) -> Tree:
    return {"norm": rmsnorm_spec(cfg.d_model), "mamba": mamba2.mamba2_specs(cfg.mamba_config())}


def _rwkv_layer_specs(cfg: ModelConfig) -> Tree:
    rcfg = cfg.rwkv_config()
    return {
        "ln1": layernorm_spec(cfg.d_model),
        "time": rwkv6.rwkv6_timemix_specs(rcfg),
        "ln2": layernorm_spec(cfg.d_model),
        "channel": rwkv6.rwkv6_channelmix_specs(rcfg),
    }


def _encoder_layer_specs(cfg: ModelConfig) -> Tree:
    return {
        "ln1": layernorm_spec(cfg.d_model),
        "attn": attn.attention_specs(cfg.attention_config()),
        "ln2": layernorm_spec(cfg.d_model),
        "mlp": ffn.gelu_mlp_specs(cfg.d_model, cfg.d_ff),
    }


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """(full_rounds, layers_per_round, epilogue_mamba_layers)."""
    period = max(cfg.attn_every, 1)
    full = cfg.num_layers // period
    return full, period, cfg.num_layers - full * period


def model_specs(cfg: ModelConfig) -> Tree:
    _require_ported(cfg)
    if cfg.family == "encoder":
        # the modality frontend is a stub: inputs are precomputed frame embeddings
        return {
            "in_proj": linear_spec(cfg.d_model, cfg.d_model, ("embed", "embed"), bias=True),
            "pos_conv": ParamSpec((128, cfg.d_model), (None, "embed"), "normal", 0.02),
            "ln_in": layernorm_spec(cfg.d_model),
            "layers": stack_specs(_encoder_layer_specs(cfg), cfg.num_layers),
            "ln_out": layernorm_spec(cfg.d_model),
            "head": linear_spec(cfg.d_model, cfg.vocab_size, ("embed", "vocab"), bias=True),
        }
    if cfg.family == "hybrid":
        full, period, rem = hybrid_layout(cfg)
        layer = _mamba_layer_specs(cfg)
        specs: Tree = {
            "embed": embedding_spec(cfg.vocab_size, cfg.d_model),
            "rounds": stack_specs(stack_specs(layer, period, "inner"), full, "layers"),
            "shared": _shared_block_specs(cfg),
            "final_norm": rmsnorm_spec(cfg.d_model),
        }
        if rem:
            specs["epilogue"] = stack_specs(layer, rem)
    elif cfg.family == "rwkv":
        specs = {
            "embed": embedding_spec(cfg.vocab_size, cfg.d_model),
            "ln_in": layernorm_spec(cfg.d_model),
            "layers": stack_specs(_rwkv_layer_specs(cfg), cfg.num_layers),
            "ln_out": layernorm_spec(cfg.d_model),
        }
    else:
        specs = {
            "embed": embedding_spec(cfg.vocab_size, cfg.d_model),
            "layers": stack_specs(_dense_layer_specs(cfg), cfg.num_layers),
            "final_norm": rmsnorm_spec(cfg.d_model),
        }
    if not cfg.tie_embeddings:
        specs["unembed"] = embedding_spec(cfg.vocab_size, cfg.d_model)
    return specs


def params_to_tensors(specs: Tree, tree: Tree, device, dtype=torch.float32) -> Tree:
    """A parameter tree (numpy arrays or tensors, any float dtype) as
    tensors on ``device`` of ``dtype`` (None: each leaf's own, with no copy
    of a tensor already there), checked leaf by leaf against the specs --
    under tensor parallelism against this rank's chunks of them."""
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
        want = tpl.local_shape(spec.shape, spec.axes)
        if tuple(leaf.shape) != want:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(leaf.shape)} != {want}")
        set_leaf(out, path, leaf.to(device=device, dtype=dtype))
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
    """Pre-norm decoder layer: h + attn(norm1(h)), then + mlp(norm2(h)) --
    or, in the MoE family, + moe(norm2(h)), dropless when a cache is given.
    Returns (h, new cache, the MoE router's aux loss or 0)."""

    def __init__(self, cfg: ModelConfig, params: Tree, *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.acfg = cfg.attention_config()
        for name in ("norm1", "attn", "norm2", "moe" if cfg.family == "moe" else "mlp"):
            setattr(self, name, Params(params[name], trainable=trainable))

    def forward(self, h, positions, cache=None, *, attn_impl: str = "auto", moe_groups: int = 1):
        a_in = rmsnorm(self.norm1, h, eps=self.cfg.norm_eps)
        a_out, new_cache = attn.attention_apply(
            self.attn, a_in, self.acfg, positions=positions, cache=cache, impl=attn_impl)
        # the norm reads the float32 sum and the residual its bf16 rounding
        # (see the module's notes)
        h32 = h.float() + a_out.float()
        f_in = rmsnorm(self.norm2, h32, eps=self.cfg.norm_eps).to(h.dtype)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        if self.cfg.family == "moe":
            f_out, aux = moe_lib.moe_apply(self.moe, f_in, self.cfg.moe_config(),
                                           moe_groups=moe_groups, dropless=cache is not None)
        elif self.cfg.mlp_type == "gelu":
            f_out = ffn.gelu_mlp_apply(self.mlp, f_in)
        else:
            f_out = ffn.swiglu_apply(self.mlp, f_in)
        return h32.to(h.dtype) + f_out, new_cache, aux


def _build_params(cfg: ModelConfig, params: Tree | None, device, seed: int,
                  trainable: bool = False):
    """The model's parameter tree on ``device``: ``params`` checked and
    converted to float32 (``trainable``: kept as they are), or drawn from
    ``torch.Generator(device)`` seeded with ``seed``; returns (tree,
    device)."""
    specs = model_specs(cfg)
    dev = resolve_device(device)
    if params is None:
        return init_params(specs, torch.Generator(device=dev).manual_seed(seed), dev), dev
    return params_to_tensors(specs, params, dev, None if trainable else torch.float32), dev


def _maybe_remat(fn, enable: bool):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) when
    ``enable``: its activations are recomputed in the backward, under the
    tensor-parallel context of the forward (``tensor_parallel.carried``),
    inside a ``models.remat`` range (the first call, the forward's, opens
    none)."""
    if not enable:
        return fn
    from torch.utils.checkpoint import checkpoint

    fn = tpl.carried(fn)

    def remat(*args, **kw):
        calls = 0

        def run(*a, **k):
            nonlocal calls
            calls += 1
            if calls == 1:
                return fn(*a, **k)
            with obs.range("models.remat"):
                return fn(*a, **k)

        return checkpoint(run, *args, use_reentrant=False, **kw)

    return remat


class _Model(nn.Module):
    """What every model shares: whether its parameters train, and whether
    a pass recomputes its layers' activations."""

    trainable: bool = False

    def _remat(self, stateless: bool) -> bool:
        """Recompute each layer in the backward: ``cfg.remat``, a trainable
        model, grad mode on and no caches."""
        return self.cfg.remat and self.trainable and stateless and torch.is_grad_enabled()

    def stacks(self) -> dict:
        """Each stacked leaf's layer modules, in the layout of its leading
        axes (a list, or for the hybrid's rounds a list of lists)."""
        return {"layers": list(self.layers)}


class _LM(_Model):
    """What the LMs share: embedding, the norms at the ends of the stack,
    unembedding, and the forward that unembeds every position."""

    def _init_ends(self, cfg: ModelConfig, params: Tree, norms=("final_norm",),
                   trainable: bool = False) -> None:
        self.cfg = cfg
        self.trainable = trainable
        self.embed = Params(params["embed"], trainable=trainable)
        for name in norms:
            setattr(self, name, Params(params[name], trainable=trainable))
        self.unembed = None if cfg.tie_embeddings else Params(params["unembed"],
                                                              trainable=trainable)

    @property
    def unembed_table(self) -> torch.Tensor:
        return (self.embed if self.cfg.tie_embeddings else self.unembed)["table"]

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        table = self.embed if self.cfg.tie_embeddings else self.unembed
        return constrain(unembed_logits(table, h), ("batch", None, "vocab"))

    def forward(self, tokens: torch.Tensor, *, caches: Any = None, with_aux: bool = False,
                moe_groups: int = 1):
        """Every position's logits and the new caches (and, ``with_aux``,
        the pass's auxiliary loss; an MoE layer dispatches in
        ``moe_groups``)."""
        h, new_caches, aux = self.hidden_aux(tokens, caches=caches, moe_groups=moe_groups)
        logits = self.logits(h)
        return (logits, new_caches, aux) if with_aux else (logits, new_caches)

    def hidden_aux(self, tokens: torch.Tensor, *, caches: Any = None, moe_groups: int = 1,
                   **impls):
        """``hidden``'s (h, new caches) and the pass's auxiliary loss (0
        outside the MoE family, whose layers dispatch in ``moe_groups``)."""
        h, new_caches = self.hidden(tokens, caches=caches, **impls)
        return h, new_caches, torch.zeros((), dtype=torch.float32, device=tokens.device)


class DenseLM(_LM):
    """A dense decoder LM on ``device`` (the card unless ``"cpu"`` is asked
    for).  ``params`` is a reference-layout tree (numpy arrays or tensors);
    without it the weights are drawn from ``torch.Generator(device)`` seeded
    with ``seed``, at the reference's scales.  ``trainable``: see the
    module's notes."""

    def __init__(self, cfg: ModelConfig, params: Tree | None = None, *, device="cuda",
                 seed: int = 0, trainable: bool = False):
        super().__init__()
        _require_class(cfg, type(self))
        params, _ = _build_params(cfg, params, device, seed, trainable)
        self._init_ends(cfg, params, trainable=trainable)
        self.layers = nn.ModuleList(
            DenseLayer(cfg, _layer_tree(params["layers"], i), trainable=trainable)
            for i in range(cfg.num_layers))

    def hidden(self, tokens: torch.Tensor, *, caches: Any = None, attn_impl: str = "auto"):
        """Final-normed hidden states [B, S, d] (bf16) and the new caches."""
        h, new_caches, _ = self.hidden_aux(tokens, caches=caches, attn_impl=attn_impl)
        return h, new_caches

    def hidden_aux(self, tokens: torch.Tensor, *, caches: Any = None, attn_impl: str = "auto",
                   moe_groups: int = 1):
        """``hidden``'s (h, new caches) and the aux loss summed over the
        layers; an MoE layer dispatches its tokens in ``moe_groups``."""
        h = constrain(embed(self.embed, tokens), ("batch", None, "embed"))
        S = tokens.shape[1]
        pos0 = caches["pos"] if caches is not None else 0
        positions = torch.arange(S, device=tokens.device) + pos0
        length = None
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
        remat = self._remat(caches is None)
        for i, layer in enumerate(self.layers):
            cache = None
            if caches is not None:
                lc = caches["layers"]
                cache = {"k": lc["k"][i], "v": lc["v"][i], "length": lc["length"]}
            h, new_cache, layer_aux = _maybe_remat(layer, remat)(
                h, positions, cache, attn_impl=attn_impl, moe_groups=moe_groups)
            aux = aux + layer_aux
            if new_cache is not None:
                length = new_cache["length"]
        h = rmsnorm(self.final_norm, h, eps=self.cfg.norm_eps)
        new_caches = None
        if caches is not None:
            layers = dict(caches["layers"], length=length)
            new_caches = {"layers": layers, "pos": pos0 + S}
        return h, new_caches, aux


class MoELM(DenseLM):
    """A Mixture-of-Experts decoder LM (granite-moe, qwen3-moe): the dense
    decoder with ``moe_apply`` in place of every MLP, tokens dispatched in
    one group.  A pass with caches (the served prefill and decode) is
    dropless; a stateless pass drops at the configured capacity, as the
    reference's does."""


class SharedBlock(nn.Module):
    """zamba2's shared transformer block on ``concat(embedding, hidden)``:
    an input projection, then a pre-norm attention and SwiGLU layer; its
    output is added to the hidden stream."""

    def __init__(self, cfg: ModelConfig, params: Tree, *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.acfg = cfg.attention_config()
        for name in ("in_proj", "norm1", "attn", "norm2", "mlp"):
            setattr(self, name, Params(params[name], trainable=trainable))

    def attend(self, h, x_emb, positions, cache=None, *, attn_impl: str = "auto"):
        """The block's input projection ``z`` and its attention output."""
        z = linear(self.in_proj, torch.cat([x_emb, h], dim=-1))
        a_in = rmsnorm(self.norm1, z, eps=self.cfg.norm_eps)
        a_out, new_cache = attn.attention_apply(
            self.attn, a_in, self.acfg, positions=positions, cache=cache, impl=attn_impl)
        return z, a_out, new_cache

    def forward(self, h, x_emb, positions, cache=None, *, attn_impl: str = "auto"):
        z, a_out, new_cache = self.attend(h, x_emb, positions, cache, attn_impl=attn_impl)
        z32 = z.float() + a_out.float()
        f_in = rmsnorm(self.norm2, z32, eps=self.cfg.norm_eps).to(z.dtype)
        z = z32.to(z.dtype) + ffn.swiglu_apply(self.mlp, f_in)
        return h + z, new_cache


class MambaLayer(nn.Module):
    """Pre-norm Mamba2 layer: h + mamba2(norm(h))."""

    def __init__(self, cfg: ModelConfig, params: Tree, *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.mcfg = cfg.mamba_config()
        self.norm = Params(params["norm"], trainable=trainable)
        self.mamba = Params(params["mamba"], trainable=trainable)

    def mix(self, h, state=None, *, ssd_impl: str = "auto"):
        """The mixer's output mamba2(norm(h)) and its new state."""
        m_in = rmsnorm(self.norm, h, eps=self.cfg.norm_eps)
        return mamba2.mamba2_apply(self.mamba, m_in, self.mcfg, state=state, impl=ssd_impl)

    def forward(self, h, state=None, *, ssd_impl: str = "auto"):
        m_out, new_state = self.mix(h, state, ssd_impl=ssd_impl)
        return h + m_out, new_state


class HybridLM(_LM):
    """The zamba2 hybrid on ``device`` (the card unless ``"cpu"`` is asked
    for): Mamba2 layers with one shared attention block invoked before every
    ``attn_every`` of them.  ``params`` is a reference-layout tree; without
    it the weights are drawn from ``torch.Generator(device)`` seeded with
    ``seed``, at the reference's scales (a stacked leaf's layer axes count
    in its fan-in, as the reference counts them)."""

    def __init__(self, cfg: ModelConfig, params: Tree | None = None, *, device="cuda",
                 seed: int = 0, trainable: bool = False):
        super().__init__()
        _require_class(cfg, HybridLM)
        params, _ = _build_params(cfg, params, device, seed, trainable)
        self._init_ends(cfg, params, trainable=trainable)
        self.full, self.period, rem = hybrid_layout(cfg)
        self.shared = SharedBlock(cfg, params["shared"], trainable=trainable)
        layers = []
        for r in range(self.full):
            round_params = _layer_tree(params["rounds"], r)
            layers += [MambaLayer(cfg, _layer_tree(round_params, k), trainable=trainable)
                       for k in range(self.period)]
        layers += [MambaLayer(cfg, _layer_tree(params["epilogue"], k), trainable=trainable)
                   for k in range(rem)]
        self.layers = nn.ModuleList(layers)

    def stacks(self) -> dict:
        n = self.full * self.period
        out = {"rounds": [list(self.layers[r * self.period:(r + 1) * self.period])
                          for r in range(self.full)]}
        if len(self.layers) > n:
            out["epilogue"] = list(self.layers[n:])
        return out

    def hidden(self, tokens: torch.Tensor, *, caches: Any = None, attn_impl: str = "auto",
               ssd_impl: str = "auto"):
        """Final-normed hidden states [B, S, d] (bf16) and the new caches.
        The shared block runs before layers 0, attn_every, 2 attn_every, ...;
        its k-th invocation keeps KV cache k."""
        h = constrain(embed(self.embed, tokens), ("batch", None, "embed"))
        x_emb = h
        S = tokens.shape[1]
        pos0 = caches["pos"] if caches is not None else 0
        positions = torch.arange(S, device=tokens.device) + pos0
        length = None
        remat = self._remat(caches is None)
        for i, layer in enumerate(self.layers):
            if i % self.period == 0:
                cache = None
                if caches is not None:
                    ac = caches["layers"]["attn"]
                    k = i // self.period
                    cache = {"k": ac["k"][k], "v": ac["v"][k], "length": ac["length"]}
                h, new_cache = _maybe_remat(self.shared, remat)(h, x_emb, positions, cache,
                                                                attn_impl=attn_impl)
                if new_cache is not None:
                    length = new_cache["length"]
            state = None
            if caches is not None:
                mc = caches["layers"]["mamba"]
                state = {"conv": mc["conv"][i], "ssm": mc["ssm"][i]}
            h, new_state = _maybe_remat(layer, remat)(h, state, ssd_impl=ssd_impl)
            if new_state is not None:
                state["conv"].copy_(new_state["conv"])
                state["ssm"].copy_(new_state["ssm"])
        h = rmsnorm(self.final_norm, h, eps=self.cfg.norm_eps)
        new_caches = None
        if caches is not None:
            layers = dict(caches["layers"], attn=dict(caches["layers"]["attn"], length=length))
            new_caches = {"layers": layers, "pos": pos0 + S}
        return h, new_caches


class RWKVLayer(nn.Module):
    """RWKV6 layer: h + time_mix(ln1(h)), then + channel_mix(ln2(h))."""

    def __init__(self, cfg: ModelConfig, params: Tree, *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.rcfg = cfg.rwkv_config()
        for name in ("ln1", "time", "ln2", "channel"):
            setattr(self, name, Params(params[name], trainable=trainable))

    def time_mix(self, h, state=None, *, wkv_impl: str = "auto"):
        """The time mix's output, its new state and the WKV's (y, h_final)."""
        t_in = layernorm(self.ln1, h, eps=self.cfg.norm_eps)
        return rwkv6.rwkv6_timemix_apply(self.time, t_in, self.rcfg, state=state,
                                         wkv_impl=wkv_impl)

    def forward(self, h, state=None, *, wkv_impl: str = "auto"):
        t_out, new_t, _ = self.time_mix(h, state["time"] if state is not None else None,
                                        wkv_impl=wkv_impl)
        # the norm reads the float32 sum and the residual its bf16 rounding
        # (see the module's notes)
        h32 = h.float() + t_out.float()
        c_in = layernorm(self.ln2, h32, eps=self.cfg.norm_eps).to(h.dtype)
        c_out, new_c = rwkv6.rwkv6_channelmix_apply(
            self.channel, c_in, self.rcfg, state=state["channel"] if state is not None else None)
        new_state = None if state is None else {"time": new_t, "channel": new_c}
        return h32.to(h.dtype) + c_out, new_state


class RWKVLM(_LM):
    """The RWKV6 LM on ``device`` (the card unless ``"cpu"`` is asked for).
    ``params`` is a reference-layout tree; without it the weights are drawn
    from ``torch.Generator(device)`` seeded with ``seed``, at the
    reference's scales."""

    def __init__(self, cfg: ModelConfig, params: Tree | None = None, *, device="cuda",
                 seed: int = 0, trainable: bool = False):
        super().__init__()
        _require_class(cfg, RWKVLM)
        params, _ = _build_params(cfg, params, device, seed, trainable)
        self._init_ends(cfg, params, norms=("ln_in", "ln_out"), trainable=trainable)
        self.layers = nn.ModuleList(
            RWKVLayer(cfg, _layer_tree(params["layers"], i), trainable=trainable)
            for i in range(cfg.num_layers))

    def hidden(self, tokens: torch.Tensor, *, caches: Any = None, wkv_impl: str = "auto"):
        """Output-normed hidden states [B, S, d] (bf16) and the new caches.
        Every pass of more than one token runs each layer's WKV through
        ``wkv_impl`` (the kernel on the card by default); a decode step is
        one recurrence step."""
        h = constrain(embed(self.embed, tokens), ("batch", None, "embed"))
        h = layernorm(self.ln_in, h, eps=self.cfg.norm_eps)
        layers = None
        if caches is not None:
            lc = caches["layers"]
            channel = lc["channel"]["shift"]
            if channel.dtype != h.dtype:     # the reference's cast (see the module's notes)
                channel = channel.to(h.dtype)
            layers = {"time": dict(lc["time"]), "channel": {"shift": channel}}
        remat = self._remat(caches is None)
        for i, layer in enumerate(self.layers):
            state = None
            if layers is not None:
                state = {part: {name: t[i] for name, t in ts.items()} for part, ts in layers.items()}
            h, new_state = _maybe_remat(layer, remat)(h, state, wkv_impl=wkv_impl)
            if new_state is not None:
                for part, ts in new_state.items():
                    for name, t in ts.items():
                        state[part][name].copy_(t)
        new_caches = None
        if layers is not None:
            new_caches = {"layers": layers, "pos": caches["pos"] + tokens.shape[1]}
        return layernorm(self.ln_out, h, eps=self.cfg.norm_eps), new_caches


class EncoderLayer(nn.Module):
    """Pre-norm encoder layer: h + attn(ln1(h)) (non-causal, no RoPE), then
    + gelu_mlp(ln2(h)); the norm reads the float32 sum and the residual its
    bf16 rounding, as in :class:`DenseLayer`."""

    def __init__(self, cfg: ModelConfig, params: Tree, *, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.acfg = cfg.attention_config()
        for name in ("ln1", "attn", "ln2", "mlp"):
            setattr(self, name, Params(params[name], trainable=trainable))

    def forward(self, h, *, attn_impl: str = "auto"):
        a_in = layernorm(self.ln1, h, eps=self.cfg.norm_eps)
        a_out, _ = attn.attention_apply(self.attn, a_in, self.acfg, impl=attn_impl)
        h32 = h.float() + a_out.float()
        f_in = layernorm(self.ln2, h32, eps=self.cfg.norm_eps).to(h.dtype)
        return h32.to(h.dtype) + ffn.gelu_mlp_apply(self.mlp, f_in)


POS_TAP_STRIDE = 16   # the reference takes every 16th of the positional conv's taps


class EncoderModel(_Model):
    """The hubert encoder on ``device`` (the card unless ``"cpu"`` is asked
    for): frames ``[B, T, d_model]`` (precomputed embeddings) -> logits
    ``[B, T, vocab]`` (bf16).  ``params``, ``seed`` and ``trainable`` as
    for :class:`DenseLM`."""

    def __init__(self, cfg: ModelConfig, params: Tree | None = None, *, device="cuda",
                 seed: int = 0, trainable: bool = False):
        super().__init__()
        _require_class(cfg, EncoderModel)
        params, _ = _build_params(cfg, params, device, seed, trainable)
        self.cfg = cfg
        self.trainable = trainable
        for name in ("in_proj", "ln_in", "ln_out", "head"):
            setattr(self, name, Params(params[name], trainable=trainable))
        self.pos_conv = nn.Parameter(params["pos_conv"], requires_grad=trainable)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, _layer_tree(params["layers"], i), trainable=trainable)
            for i in range(cfg.num_layers))

    def positional(self, h: torch.Tensor) -> torch.Tensor:
        """The conv positional embedding's output gelu(conv(h)), in h's dtype:
        taps 0, 16, ..., 112 of the 128, over h padded by (64, 63)."""
        pos = self.pos_conv.to(h.dtype)                    # [Kw, d]
        Kw, T = pos.shape[0], h.shape[1]
        hp = torch.nn.functional.pad(h, (0, 0, Kw // 2, Kw - 1 - Kw // 2))
        conv = torch.zeros_like(h)
        for i in range(0, Kw, POS_TAP_STRIDE):
            conv = conv + hp[:, i:i + T] * pos[i]
        return ffn.gelu_tanh(conv)

    def forward(self, frames: torch.Tensor, *, attn_impl: str = "auto") -> torch.Tensor:
        h = linear(self.in_proj, frames)
        # the input norm reads the float32 sum (see the module's notes)
        h = layernorm(self.ln_in, h.float() + self.positional(h).float(),
                      eps=self.cfg.norm_eps).to(h.dtype)
        remat = self._remat(True)
        for layer in self.layers:
            h = _maybe_remat(layer, remat)(h, attn_impl=attn_impl)
        h = layernorm(self.ln_out, h, eps=self.cfg.norm_eps)
        tp = tpl.current()
        if tp is not None and tp.splits("vocab"):
            h = tpl.enter(h, tp)       # the head is column-parallel over the vocab
        return constrain(linear(self.head, h), ("batch", None, "vocab"))


LM = DenseLM | MoELM | HybridLM | RWKVLM
Model = LM | EncoderModel
MODELS = {"dense": DenseLM, "moe": MoELM, "hybrid": HybridLM, "rwkv": RWKVLM,
          "encoder": EncoderModel}


def build_lm(cfg: ModelConfig, params: Tree | None = None, *, device="cuda", seed: int = 0,
             trainable: bool = False) -> Model:
    """The model class of ``cfg``'s family (the encoder's too), built on
    ``device``; ``trainable``: see the module's notes."""
    _require_ported(cfg)
    return MODELS[cfg.family](cfg, params, device=device, seed=seed, trainable=trainable)


# ===========================================================================
# Top-level forward / decode (the reference's function names)
# ===========================================================================

def forward_lm(model: LM, tokens: torch.Tensor, *, caches: Any = None, moe_groups: int = 1):
    """Returns (logits [B, S, vocab] bf16, new_caches, aux loss): the MoE
    router's aux summed over the layers, 0 for the other families."""
    return model(tokens, caches=caches, with_aux=True, moe_groups=moe_groups)


def _backbone_hidden(model: LM, tokens: torch.Tensor, *, moe_groups: int = 1):
    """Hidden states before the unembedding [B, S, d] and the aux loss
    (for the streamed loss)."""
    h, _, aux = model.hidden_aux(tokens, moe_groups=moe_groups)
    return h, aux


def lm_loss(model: LM, batch: dict, *, moe_groups: int = 1):
    """Next-token cross entropy of ``batch["tokens"]`` [B, S + 1]: the
    first S tokens predict the last S; returns (loss, {"ce", "aux"}), the
    loss ``ce + aux`` as the reference adds them.  With
    ``cfg.loss_seq_chunks > 1`` the logits are made and dropped chunk by
    chunk (``seq_chunked_cross_entropy``)."""
    tokens = batch["tokens"]
    chunks = model.cfg.loss_seq_chunks
    if chunks > 1:
        h, aux = _backbone_hidden(model, tokens[:, :-1], moe_groups=moe_groups)
        ce = seq_chunked_cross_entropy(h, model.unembed_table, tokens[:, 1:], chunks=chunks)
    else:
        logits, _, aux = forward_lm(model, tokens[:, :-1], moe_groups=moe_groups)
        ce = softmax_cross_entropy(logits, tokens[:, 1:])
    return ce + aux, {"ce": ce, "aux": aux}


def forward_encoder(model: EncoderModel, frames: torch.Tensor) -> torch.Tensor:
    """hubert: frames [B, T, d_model] (stub frontend) -> logits [B, T, vocab]."""
    return model(frames)


def encoder_loss(model: EncoderModel, batch: dict):
    """Masked cross entropy of ``batch["targets"]`` [B, T] over the
    positions ``batch["mask"]`` marks; returns (loss, {"ce", "aux"})."""
    logits = forward_encoder(model, batch["frames"])
    ce = softmax_cross_entropy(logits, batch["targets"], mask=batch["mask"])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=logits.device)}


def loss_fn(model: Model, batch: dict, *, moe_groups: int = 1):
    """The family's training loss: ``encoder_loss`` or ``lm_loss``."""
    if model.cfg.family == "encoder":
        return encoder_loss(model, batch)
    return lm_loss(model, batch, moe_groups=moe_groups)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                device="cuda") -> dict:
    """Zeroed decode caches: every attention layer's (dense) or every shared
    block invocation's (hybrid) ``attention.init_cache`` stacked on a leading
    axis, and every Mamba2 layer's ``init_mamba_state`` (hybrid), the conv
    windows in ``dtype`` and the SSM states in float32, or every RWKV6
    layer's ``init_rwkv_state`` (rwkv), the shifts in ``dtype`` and the WKV
    states in float32."""
    _require_ported(cfg)
    if cfg.family == "encoder":
        raise ValueError(f"no decode caches for family {cfg.family}")
    dev = resolve_device(device)

    def kv(n: int) -> dict:
        shape = (n, batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev), "length": 0}

    def stacked(state: dict) -> dict:
        return {name: torch.zeros((cfg.num_layers, *t.shape), dtype=t.dtype, device=dev)
                for name, t in state.items()}

    if cfg.family in ("dense", "moe"):
        return {"layers": kv(cfg.num_layers), "pos": 0}
    if cfg.family == "rwkv":
        state = rwkv6.init_rwkv_state(cfg.rwkv_config(), batch, dtype, dev)
        return {"layers": {part: stacked(s) for part, s in state.items()}, "pos": 0}
    full, _, rem = hybrid_layout(cfg)
    mamba = stacked(mamba2.init_mamba_state(cfg.mamba_config(), batch, dtype, dev))
    return {"layers": {"attn": kv(full + (1 if rem else 0)), "mamba": mamba}, "pos": 0}


def decode_step(model: LM, caches, tokens: torch.Tensor):
    """One serve step: tokens [B, 1] -> (logits [B, 1, V], new_caches)."""
    logits, new_caches = model(tokens, caches=caches)
    return logits, new_caches
