"""Mixture-of-Experts layer with top-k routing and capacity-bounded local
dispatch (the port of ``src/repro/models/moe.py``).

Tokens are viewed as ``[G, T_local, d]`` (``moe_groups``); each group
dispatches its tokens into an expert buffer ``[G, E, C, d]`` and combines
them back.  Capacity is per group, ``C = ceil(T_local * k / E *
capacity_factor)``; an assignment past it is dropped (its combine weight is
zero), as in Switch/GShard.  ``dropless`` (the served path) takes ``C =
T_local``, so no assignment can overflow.

The reference's semantics, step by step:

* routing in float32: ``x @ router.w``, softmax, top-k, the top-k
  probabilities renormalised;
* the Switch load-balancing aux loss;
* capacity positions first come, first served in token-major assignment
  order -- a running count over a one-hot (``[G, T*k, E]``), or with
  ``sort_dispatch`` one stable argsort a group (:func:`_sorted_positions`):
  the same positions;
* the expert products in bf16 on the stacked weights (``bmm`` over E: plain
  matrix products, which the reference also leaves outside any Pallas
  kernel), ``silu(gate) * up`` with one rounding per operation
  (``ffn.silu``);
* the combine in bf16: each token's k weighted expert outputs added into a
  zero row in assignment order, one bf16 rounding an addition, as the
  reference's scatter-add ``zeros.at[token].add`` does on the host.

The dispatch buffer is built by a gather through a ``[E, C]`` slot table
(the reference's ``sort_dispatch`` form) in both modes: each kept
assignment owns its slot, so the buffer equals the one-hot scatter-add's.
Its gradient gathers each token's k kept slots back and adds them in
assignment order (:class:`_DispatchGather`), where ``index_select``'s own
backward adds them with atomics in an order that changes from run to run.
The reference's activation constraints (``distributed.sharding.constrain``)
are called at its sites.

Under tensor parallelism (``distributed.tensor_parallel``) the router and
its aux loss are replicated (a router split over the experts computes
its experts' logits, which are gathered; every rank routes alike and adds
the aux loss once), and each rank
computes its own experts (the rules' ``experts`` split, qwen3-moe) or its
own columns of every expert's hidden layer (``expert_ff``, granite-moe's
40 experts on 16 ranks): it dispatches the assignments to its experts,
combines its experts' (or its partial) outputs in assignment order, and
an all-reduce adds the ranks' combines.  The sum's order differs from one
card's in-order bf16 adds, so the output is held to a tolerance.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import ParamSpec, Tree, linear_spec
from repro_torch.models.ffn import silu


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                 # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # capacity positions by one stable argsort instead of the one-hot
    # running count (same positions, no [T*k, E] tensor)
    sort_dispatch: bool = False


def moe_specs(cfg: MoEConfig) -> Tree:
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": linear_spec(d, E, ("embed", "experts")),
        "gate": ParamSpec((E, d, f), ("experts", "embed", "expert_ff"), "normal",
                          1.0 / math.sqrt(d)),
        "up": ParamSpec((E, d, f), ("experts", "embed", "expert_ff"), "normal",
                        1.0 / math.sqrt(d)),
        "down": ParamSpec((E, f, d), ("experts", "expert_ff", "embed"), "normal",
                          1.0 / math.sqrt(f)),
    }


def _sorted_positions(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Position of each assignment within its expert (first-come order) by
    one stable argsort a group: ``flat_e [G, A]`` -> ``[G, A]`` int64."""
    G, A = flat_e.shape
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((G, num_experts), dtype=torch.int64, device=flat_e.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts                       # [G, E]
    ranks = torch.arange(A, device=flat_e.device)[None, :] - torch.gather(starts, 1, sorted_e)
    return torch.zeros_like(flat_e).scatter_(1, order, ranks)


def _cumsum_positions(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """The same positions by a running count over a one-hot: ``[G, E, A]``,
    the count running along its last (contiguous) axis, since a scan down
    the long outer axis of ``[G, A, E]`` runs one CUDA thread a column (1.6
    s of granite-moe-3b-a800m's 2.0 s prefill at 8 x 2048 tokens in
    ``chip_smoke.py``'s profile, NVIDIA H100 80GB HBM3 at 700 W)."""
    onehot = torch.nn.functional.one_hot(flat_e, num_experts).transpose(1, 2).contiguous()
    pos_in_e = torch.cumsum(onehot, dim=2) - 1
    return torch.gather(pos_in_e, 1, flat_e[:, None, :])[:, 0, :]


def moe_capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    return max(
        1,
        int(math.ceil(tokens_per_group * cfg.top_k / cfg.num_experts * cfg.capacity_factor)),
    )


def route(params, xt: torch.Tensor, cfg: MoEConfig):
    """The float32 router on ``xt [G, Tg, d]``: ``(logits, probs, top_w,
    top_idx)``, the top-k weights renormalised.  A router split over the
    experts (tensor parallelism; ``xt`` has entered the split region) gives
    each rank its experts' logits, gathered whole: every rank routes
    alike."""
    w = params["router"]["w"].to(torch.float32)
    logits = torch.einsum("gtd,de->gte", xt.to(torch.float32), w)
    tp = tpl.current()
    if tp is not None and tp.splits("experts"):
        logits = tpl.gather(logits, 2, cfg.num_experts, tp, replicated=True)
    return _routed(logits, cfg)


def _routed(logits: torch.Tensor, cfg: MoEConfig):
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_probs / torch.clamp_min(top_probs.sum(-1, keepdim=True), 1e-9)
    return logits, probs, top_w, top_idx


class _DispatchGather(torch.autograd.Function):
    """``x_pad[rows]`` (rows ``[G * E * C]`` into ``x_pad [G * (Tg + 1),
    d]``, its last row of a group zero) whose backward gives token t of
    group g the sum of its kept assignments' slots ``slot [G, Tg * k]``,
    taken in assignment order: the same bits on every run."""

    @staticmethod
    def forward(ctx, x_pad, rows, slot, keep):
        ctx.save_for_backward(slot, keep)
        ctx.n_rows = x_pad.shape[0]
        return x_pad.index_select(0, rows)

    @staticmethod
    def backward(ctx, grad_buf):
        slot, keep = ctx.saved_tensors
        G, A = slot.shape
        Tg, d = ctx.n_rows // G - 1, grad_buf.shape[-1]
        g = grad_buf.index_select(0, slot.reshape(-1)).reshape(G, Tg, A // Tg, d)
        g = torch.where(keep.reshape(G, Tg, A // Tg, 1), g, torch.zeros((), dtype=g.dtype,
                                                                       device=g.device))
        acc = g[:, :, 0]
        for j in range(1, A // Tg):
            acc = acc + g[:, :, j]
        # the zero row of each group takes no gradient
        grad = torch.cat([acc, torch.zeros((G, 1, d), dtype=acc.dtype, device=acc.device)], 1)
        return grad.reshape(ctx.n_rows, d), None, None, None


def moe_apply(
    params,
    x: torch.Tensor,             # [B, S, d]
    cfg: MoEConfig,
    *,
    moe_groups: int = 1,
    dropless: bool = False,
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output [B, S, d] in ``compute_dtype``, aux loss scalar
    float32)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    G = moe_groups
    T = B * S
    if T % G != 0:
        raise ValueError(f"tokens {T} not divisible by moe_groups {G}")
    Tg = T // G
    C = Tg if dropless else moe_capacity(Tg, cfg)
    xt = constrain(x.reshape(G, Tg, d), ("moe_group", None, "embed"))
    dev = x.device
    tp = tpl.current()
    if tp is not None and not (tp.splits("experts") or tp.splits("expert_ff")):
        tp = None
    e0, e1 = tp.chunk(E) if tp is not None and tp.splits("experts") else (0, E)
    El = e1 - e0                                   # this rank's experts

    # the tokens enter the split region once, for the experts and a router
    # split over them (one all-reduce sums both paths' gradients)
    xin = tpl.enter(xt, tp) if tp is not None else xt

    # ---- routing (float32) ----------------------------------------------
    _, probs, top_w, top_idx = route(params, xin if tp is not None and tp.splits("experts")
                                     else xt, cfg)

    # ---- load-balancing auxiliary loss (Switch) --------------------------
    dispatch_frac = torch.nn.functional.one_hot(top_idx, E).to(torch.float32).mean(dim=(1, 2))
    prob_frac = probs.mean(dim=1)                                       # [G, E]
    aux = cfg.router_aux_weight * E * (dispatch_frac * prob_frac).sum(-1).mean()

    # ---- capacity positions ------------------------------------------------
    flat_e = top_idx.reshape(G, Tg * k)
    if cfg.sort_dispatch:
        pos = _sorted_positions(flat_e, E)
    else:
        pos = _cumsum_positions(flat_e, E)
    keep = pos < C
    if tp is not None:
        # the rank's assignments: those to its experts; the tokens and the
        # combine weights enter the split region (their gradients summed)
        keep = keep & (flat_e >= e0) & (flat_e < e1)
        xt, top_w = xin, tpl.enter(top_w, tp)
        flat_e = (flat_e - e0).clamp(0, El - 1)
    w_flat = top_w.reshape(G, Tg * k) * keep.to(torch.float32)

    # ---- dispatch: tokens -> [G, E, C, d] through a slot table -------------
    token_of_assign = torch.arange(Tg, device=dev).repeat_interleave(k)   # [Tg*k]
    clipped_pos = torch.clamp_max(pos, C - 1)
    # a dropped assignment writes to an extra expert row that is cut away
    e_safe = torch.where(keep, flat_e, torch.full_like(flat_e, El))
    slot_token = torch.full((G, El + 1, C), Tg, dtype=torch.int64, device=dev)
    g_idx = torch.arange(G, device=dev)[:, None]
    slot_token[g_idx, e_safe, clipped_pos] = token_of_assign
    rows = slot_token[:, :El] + g_idx[..., None] * (Tg + 1)              # padded row ids
    # each assignment's slot in the buffer (a dropped one's is not its own)
    slot = flat_e * C + clipped_pos + g_idx * (El * C)                   # [G, Tg*k]
    x_pad = torch.cat([xt.to(compute_dtype),
                       torch.zeros((G, 1, d), dtype=compute_dtype, device=dev)], dim=1)
    buf = _DispatchGather.apply(x_pad.reshape(G * (Tg + 1), d), rows.reshape(-1), slot, keep)
    buf = constrain(buf.reshape(G, El, C, d), ("moe_group", "experts", None, "embed"))
    buf = buf.reshape(G * El, C, d)

    # ---- expert computation (stacked products over E) ----------------------
    gate, up, down = (params[n].to(compute_dtype) for n in ("gate", "up", "down"))
    if G > 1:
        gate, up, down = (w.repeat(G, 1, 1) for w in (gate, up, down))
    h = silu(torch.bmm(buf, gate)) * torch.bmm(buf, up)
    h = constrain(h.reshape(G, El, C, -1), ("moe_group", "experts", None, "expert_ff"))
    y = torch.bmm(h.reshape(G * El, C, -1), down)
    y = constrain(y.reshape(G, El, C, d), ("moe_group", "experts", None, "embed"))
    y = y.reshape(G * El * C, d)

    # ---- combine: each token's k outputs added in order, in bf16 -------------
    vals = y.index_select(0, slot.reshape(-1)).reshape(G, Tg * k, d)
    vals = (vals * w_flat[..., None].to(vals.dtype)).reshape(G, Tg, k, d)
    out = torch.zeros((G, Tg, d), dtype=vals.dtype, device=dev)
    for j in range(k):
        out = out + vals[:, :, j]
    if tp is not None:
        out = tpl.leave(out, tp)       # the ranks' combines added (float32, then bf16)
    out = constrain(out, ("moe_group", None, "embed"))
    return out.reshape(B, S, d).to(compute_dtype), aux


def moe_ref(params, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Dense float32 oracle: every token through its top-k experts, no
    capacity (the reference's ``moe_ref``)."""
    B, S, d = x.shape
    xt = x.reshape(-1, d).to(torch.float32)
    _, _, top_w, top_idx = route(params, xt[None], cfg)
    top_w, top_idx = top_w[0], top_idx[0]                              # [T, k]
    gate = params["gate"].to(torch.float32)[top_idx]                    # [T, k, d, f]
    up = params["up"].to(torch.float32)[top_idx]
    down = params["down"].to(torch.float32)[top_idx]                    # [T, k, f, d]
    g = torch.einsum("td,tkdf->tkf", xt, gate)
    u = torch.einsum("td,tkdf->tkf", xt, up)
    y = torch.einsum("tkf,tkfd->tkd", torch.nn.functional.silu(g) * u, down)
    return (top_w[..., None] * y).sum(1).reshape(B, S, d)
