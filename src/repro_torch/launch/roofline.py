"""Roofline analysis of one rank's traced program on the H100's data-sheet
peaks, and the model-level bounds the smoke run and the report share.

The reference parses the compiled, SPMD-partitioned HLO of one device.  The
port traces one rank's real program on fake tensors
(``torch._subclasses.fake_tensor.FakeTensorMode``: shapes and dtypes, no
data) under :class:`DryRunRecorder`, a ``TorchDispatchMode`` stacked over
the fake mode, which sees every aten op the rank dispatches:

  flops        ``torch.utils.flop_counter``'s registry, op by op as
               ``FlopCounterMode`` counts the same ops, and apart the part
               whose operands are float32 (not bf16 or fp16);
  bytes        operands plus outputs of every op that is not a view: eager
               execution sends every op through device memory.  Views,
               reshapes, metadata and bare allocations are free, as the
               reference's ``_FREE_OPS`` are;
  collectives  the ``_c10d_functional.*`` and ``c10d.*`` ops by kind
               (all-reduce, all-gather, reduce-scatter, all-to-all), each
               with its count and the bytes of its per-rank output;
  kernels      the hand-written kernels' shape-only launches
               (``kernels._cuda.record_shape_only``), by name: launches,
               operations (bf16 on the tensor cores or float32) and bytes;
  live bytes   each fake output's storage on the first argument's device
               type from its creation to its death (a weakref finalizer);
               the peak less the arguments is the program's temporary
               memory.

Eager execution dispatches every layer, so no loop trip count scales
anything, and ``torch.utils.checkpoint``'s recomputation is recorded
because it runs.  :func:`analyze` gives the reference's keys (flops, bytes,
collectives) plus ``aten_flops``, ``aten_flops_f32`` and ``kernels``; its
flops and bytes hold the kernels' too.

Terms (per rank, seconds), on the constants of ``launch.mesh``:
    T_compute    = bf16 flops / 989e12
                   + float32 flops (aten ops' and kernels') / 67e12
    T_memory     = bytes / 3.35e12
    T_collective = wire bytes / 50e9   (all-reduce counts 2x; the network
                   bandwidth a GPU has between 8-GPU nodes, which every
                   16-rank mesh axis crosses)

The second half holds the model-level bounds of ``chip_smoke.py`` (one
copy): a prefill's, a training step's and a decode step's least work.
"""

from __future__ import annotations

import math
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import _cuda
from repro_torch.launch import mesh as mesh_lib

_aten = torch.ops.aten

# allocations move no device memory (views are found from their schema;
# metadata ops return no tensor)
_FREE = {
    _aten.empty.memory_format, _aten.empty_like.default, _aten.empty_strided.default,
    _aten.new_empty.default, _aten.new_empty_strided.default,
}

# collective op name -> kind; a c10d op's output is its first argument (in
# place), a functional op's is its result
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def local_bytes(tree) -> int:
    """The bytes this rank holds of every tensor in ``tree`` (a DTensor's
    local shard; nested dicts, lists and tuples; other leaves are 0)."""
    return sum(map(_nbytes, _tensors(tree)))


class DryRunRecorder(TorchDispatchMode):
    """Records one rank's traced program (see the module's notes).  Enter it
    inside a ``FakeTensorMode``, after :meth:`track_arguments` has counted
    the inputs; :func:`analyze` reads it."""

    def __init__(self):
        super().__init__()
        # live bytes count the storages on the first argument's device
        # type: a host copy takes no device memory
        self.device_type: str | None = None
        self.flops = 0                  # aten ops', from flop_counter's registry
        self.flops_f32 = 0              # the part of them on float32 operands
        self.bytes = 0                  # aten ops' operands plus outputs
        self.collectives: dict[str, dict] = {}
        self.kernels: dict[str, dict] = {}
        self.arguments = 0              # bytes of the inputs' storages
        self.live = 0                   # bytes of the live storages
        self.peak = 0
        self._storages: set[int] = set()

    # -- live bytes ---------------------------------------------------------
    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it dies; its bytes if it was
        new."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        if not _cuda.is_fake(t):
            return 0
        if self.device_type is None:
            self.device_type = t.device.type
        if t.device.type != self.device_type:
            return 0
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._storages:
            return 0
        n = storage.nbytes()
        self._storages.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._release, key, n)
        return n

    def _release(self, key: int, n: int) -> None:
        self._storages.discard(key)
        self.live -= n

    def track_arguments(self, tree) -> int:
        """Count the storages of every fake tensor in ``tree`` (the
        program's inputs) as arguments; returns their bytes."""
        n = sum(self._track(t) for t in _tensors(tree))
        self.arguments += n
        return n

    @property
    def temp(self) -> int:
        """The peak of live bytes less the arguments'."""
        return self.peak - self.arguments

    # -- kernels ------------------------------------------------------------
    def record_kernel(self, name: str, ops: int, nbytes: int, dtype: str) -> None:
        k = self.kernels.setdefault(name, {"launches": 0, "ops": 0, "bytes": 0, "dtype": dtype})
        k["launches"] += 1
        k["ops"] += ops
        k["bytes"] += nbytes

    def __enter__(self):
        _cuda._DRY_RUNS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _cuda._DRY_RUNS.remove(self)
        return super().__exit__(*exc)

    # -- every aten op ------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        # FlopCounterMode's order: an op with a composite decomposition runs
        # as its pieces, each recorded
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            if _tensors(args)[0].dtype not in (torch.bfloat16, torch.float16):
                self.flops_f32 += n
        if func.namespace in ("_c10d_functional", "c10d"):
            self._collective(func, args, out)
        elif func not in _FREE and not func.is_view:
            outs = _tensors(out)
            if outs:
                self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + sum(map(_nbytes, outs))
        for t in _tensors(out):
            self._track(t)
        return out

    def _collective(self, func, args, out) -> None:
        name = func._overloadpacket.__name__
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is None:            # wait_tensor, barrier, ...
            return
        target = args[0] if func.namespace == "c10d" else out
        n = sum(map(_nbytes, _tensors(target)))
        bucket = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
        bucket["count"] += 1
        bucket["bytes"] += n
        self.bytes += n             # collectives also touch device memory


def analyze(recorder: DryRunRecorder) -> dict[str, Any]:
    """The reference's ``analyze_hlo`` keys from a recorder: ``flops`` and
    ``bytes`` (the aten ops' and the kernels'), ``collectives`` by kind, and
    ``kernels`` by name (launches, operations, their dtype, bytes);
    ``aten_flops`` is the aten ops' part, ``FlopCounterMode``'s count, and
    ``aten_flops_f32`` the part of it on float32 operands."""
    kernels = {name: dict(k) for name, k in recorder.kernels.items()}
    return {
        "flops": float(recorder.flops + sum(k["ops"] for k in kernels.values())),
        "aten_flops": float(recorder.flops),
        "aten_flops_f32": float(recorder.flops_f32),
        "bytes": float(recorder.bytes + sum(k["bytes"] for k in kernels.values())),
        "collectives": {kind: {"count": float(b["count"]), "bytes": float(b["bytes"])}
                        for kind, b in recorder.collectives.items()},
        "kernels": kernels,
    }


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS per (arch x shape): the reference's arithmetic
# ---------------------------------------------------------------------------

def model_flops(cfg, cell) -> float:
    """Global useful FLOPs for one step: 6*N*D for train (4x with remat
    excluded -- this is the *useful* count), 2*N*D for fwd-only, plus exact
    attention terms.  MoE uses active params."""
    from repro_torch.models.api import model_specs
    from repro_torch.models.common import param_count

    specs = model_specs(cfg)
    total = param_count(specs)
    embed_rows = cfg.vocab_size * cfg.d_model
    if cfg.family == "encoder":
        matmul_params = total
    elif cfg.tie_embeddings:
        matmul_params = total          # single table, used in the unembed matmul
    else:
        matmul_params = total - embed_rows  # input gather is FLOP-free

    if cfg.family == "moe":
        per_expert = 3 * cfg.d_model * cfg.d_ff
        inactive = cfg.num_layers * (cfg.num_experts - cfg.num_experts_per_token) * per_expert
        matmul_params -= inactive

    B, S = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        tokens = B * S
        mult = 6.0
    elif cell.kind == "prefill":
        tokens = B * S
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = B
        mult = 2.0

    flops = mult * matmul_params * tokens

    # attention score/value matmuls (full-attention families)
    Dh = cfg.resolved_head_dim
    H = cfg.num_heads
    if cfg.family in ("dense", "moe", "encoder"):
        L_attn = cfg.num_layers
    elif cfg.family == "hybrid":
        L_attn = math.ceil(cfg.num_layers / max(cfg.attn_every, 1))
    else:
        L_attn = 0
    if L_attn:
        if cell.kind == "decode":
            # one new token attends over the full cache: QK^T + PV
            flops += 4.0 * B * H * Dh * S * L_attn
        else:
            causal = 0.5 if cfg.causal else 1.0
            fwd_attn = 4.0 * B * H * Dh * S * S * causal * L_attn
            flops += fwd_attn * (3.0 if cell.kind == "train" else 1.0)

    # SSM/linear-attention state math (mamba2 / rwkv6)
    if cfg.family == "hybrid":
        mcfg = cfg.mamba_config()
        per_tok = 3 * 2 * mcfg.d_inner * mcfg.d_state  # h update + y readout
        flops += mult / 2.0 * per_tok * (B * S if cell.kind != "decode" else B) * cfg.num_layers
    if cfg.family == "rwkv":
        C = cfg.rwkv_head_dim
        per_tok = 3 * 2 * cfg.d_model * C
        flops += mult / 2.0 * per_tok * (B * S if cell.kind != "decode" else B) * cfg.num_layers

    return flops


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------

_WIRE_FACTOR = {
    "all-reduce": 2.0,       # reduce-scatter + all-gather equivalent
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def roofline_terms(analysis: dict, *, chips: int) -> dict:
    """Per-rank seconds for each roofline term.  ``analysis`` is one rank's
    program, so flops and bytes are already per rank; the float32
    operations (aten ops' on float32 operands, float32 kernels') are timed
    at the float32 rate, everything else at the bf16 tensor-core peak."""
    f32_ops = analysis.get("aten_flops_f32", 0.0) + sum(
        k["ops"] for k in analysis.get("kernels", {}).values() if k["dtype"] == "f32")
    t_compute = ((analysis["flops"] - f32_ops) / mesh_lib.PEAK_FLOPS_BF16
                 + f32_ops / mesh_lib.PEAK_FLOPS_FP32)
    t_memory = analysis["bytes"] / mesh_lib.HBM_BW
    wire = 0.0
    for kind, b in analysis.get("collectives", {}).items():
        wire += b["bytes"] * _WIRE_FACTOR.get(kind, 1.0)
    t_coll = wire / mesh_lib.NETWORK_BW
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "wire_bytes": wire,
    }


def summarize_cell(result: dict, cfg, cell) -> dict:
    """The roofline of one dry-run result: its terms, the model's useful
    FLOPs against the traced program's over every rank, and the share of
    the bf16 peak that the useful FLOPs would take at the modelled step
    time, on 512 ranks for a multi-pod result and 256 for a single pod."""
    chips = 512 if result.get("multi_pod") else 256
    analysis = result["analysis"]
    terms = roofline_terms(analysis, chips=chips)
    mf = model_flops(cfg, cell)
    hlo_flops_global = analysis["flops"] * chips
    terms.update(
        model_flops_global=mf,
        hlo_flops_global=hlo_flops_global,
        useful_ratio=(mf / hlo_flops_global) if hlo_flops_global else float("nan"),
        # roofline fraction: useful compute time / total modeled time
        step_time_s=max(terms["t_compute_s"], terms["t_memory_s"], terms["t_collective_s"]),
    )
    terms["roofline_fraction"] = (
        (mf / chips / mesh_lib.PEAK_FLOPS_BF16) / terms["step_time_s"]
        if terms["step_time_s"] > 0
        else float("nan")
    )
    return terms


# ---------------------------------------------------------------------------
# Model-level bounds (the smoke run's, one copy)
# ---------------------------------------------------------------------------

def shared_calls(cfg) -> int:
    """The hybrid's calls of its shared block in one pass."""
    from repro_torch.models.transformer import hybrid_layout

    full, _, rem = hybrid_layout(cfg)
    return full + (1 if rem else 0)


def prefill_flops(cfg, batch: int, seq: int) -> int:
    """Operations of a prefill to last-position logits: every projection
    (2 per multiply-add) over every token, causal attention over the
    prompt's pairs, and the last position's unembedding."""
    d, dh = cfg.d_model, cfg.resolved_head_dim
    proj = d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = (2 if cfg.mlp_type == "gelu" else 3) * d * cfg.d_ff
    attn = 4 * cfg.num_heads * dh * seq * (seq + 1) // 2 * batch
    return cfg.num_layers * (2 * (proj + mlp) * batch * seq + attn) + 2 * batch * d * cfg.vocab_size


def hybrid_prefill_flops(cfg, batch: int, seq: int) -> int:
    """bf16 operations of a hybrid prefill to last-position logits: every
    projection of the shared block's invocations and of the Mamba2 layers
    (the float32 dt projection included) over every token, causal attention
    over the prompt's pairs, and the last position's unembedding.  The SSD
    scans' float32 operations are counted apart
    (``kernels.mamba2_ssd.ssd_work``)."""
    d, dh, m = cfg.d_model, cfg.resolved_head_dim, cfg.mamba_config()
    inv = shared_calls(cfg)
    shared = 2 * d * d + d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads) + 3 * d * cfg.d_ff
    mamba = d * (2 * m.d_inner + 2 * m.d_state + m.num_heads) + m.d_inner * d
    attn = 4 * cfg.num_heads * dh * seq * (seq + 1) // 2 * batch
    tokens = batch * seq
    return (inv * (2 * shared * tokens + attn) + cfg.num_layers * 2 * mamba * tokens
            + 2 * batch * d * cfg.vocab_size)


def rwkv_flops(cfg, batch: int, seq: int, every_position: bool) -> tuple[int, int]:
    """(bf16, float32) operations of a pass over ``batch x seq`` tokens:
    every bf16 projection (r, k, v, g, o, the channel mix's key, value and
    receptance; 2 a multiply-add) over every token and the unembedding of
    every position or of the last; the float32 low-rank products of the
    ddlerp and the decay.  The WKV's operations are counted apart
    (``kernels.rwkv6_wkv.wkv_work``)."""
    d, f, r = cfg.d_model, cfg.d_ff, cfg.lora_rank
    matrix = 6 * d * d + 2 * d * f
    lora = 10 * d * r + 2 * d * r
    tokens = batch * seq
    bf16 = 2 * cfg.num_layers * matrix * tokens + 2 * d * cfg.vocab_size * (
        tokens if every_position else batch)
    return bf16, 2 * cfg.num_layers * lora * tokens


def train_flops(cfg, batch: int, seq: int) -> int:
    """A training step's operations before remat: three times the forward's
    (every projection over every token, attention over its pairs, the
    unembedding or head at every position)."""
    d, dh, T = cfg.d_model, cfg.resolved_head_dim, batch * seq
    proj = d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = (2 if cfg.family == "encoder" or cfg.mlp_type == "gelu" else 3) * d * cfg.d_ff
    pairs = seq * (seq + 1) // 2 if cfg.causal else seq * seq
    attn = 4 * cfg.num_heads * dh * pairs * batch
    ends = 2 * d * cfg.vocab_size * T + (2 * d * d * T if cfg.family == "encoder" else 0)
    return 3 * (cfg.num_layers * (2 * (proj + mlp) * T + attn) + ends)


def family_train_ops(cfg, batch: int, seq: int) -> tuple[int, int]:
    """(bf16, float32) operations of a training step before remat: three
    times the forward's projections (2 a multiply-add) over every token,
    attention over its causal pairs and the unembedding at every position;
    the MoE's active experts (top-k of them a token) and float32 router;
    the hybrid's float32 dt projection; rwkv6's float32 low-rank products;
    and each scan's forward and backward once (``ssd_work`` and
    ``ssd_bwd_work``, ``wkv_work`` and ``wkv_bwd_work``)."""
    from repro_torch.kernels.mamba2_ssd import ssd_bwd_work, ssd_work
    from repro_torch.kernels.rwkv6_wkv import wkv_bwd_work, wkv_work

    d, T, L = cfg.d_model, batch * seq, cfg.num_layers
    ends = 2 * d * cfg.vocab_size * T
    if cfg.family == "rwkv":
        bf16, f32 = rwkv_flops(cfg, batch, seq, every_position=True)
        scan = L * (wkv_work(batch, seq, cfg.num_heads)[0]
                    + wkv_bwd_work(batch, seq, cfg.num_heads)[0])
        return 3 * bf16, 3 * f32 + scan
    dh = cfg.resolved_head_dim
    proj = d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    attn = 4 * cfg.num_heads * dh * seq * (seq + 1) // 2 * batch
    if cfg.family == "hybrid":
        m = cfg.mamba_config()
        inv = shared_calls(cfg)
        shared = 2 * d * d + proj + 3 * d * cfg.d_ff
        mamba = d * (2 * m.d_inner + 2 * m.d_state) + m.d_inner * d
        bf16 = inv * (2 * shared * T + attn) + L * 2 * mamba * T + ends
        scan = L * (ssd_work(batch, seq, m.num_heads)[0] + ssd_bwd_work(batch, seq, m.num_heads)[0])
        return 3 * bf16, 3 * L * 2 * d * m.num_heads * T + scan
    experts = cfg.num_experts_per_token * 3 * d * cfg.d_ff
    bf16 = L * (2 * (proj + experts) * T + attn) + ends
    return 3 * bf16, 3 * L * 2 * d * cfg.num_experts * T


def family_launches(cfg) -> dict:
    """Each kernel wrapper's launches a training step: the forward twice a
    layer (remat), the backward once."""
    L = cfg.num_layers
    if cfg.family == "rwkv":
        return {"rwkv6_wkv": 2 * L, "rwkv6_wkv_bwd": L}
    if cfg.family == "hybrid":
        inv = shared_calls(cfg)
        return {"mamba2_ssd": 2 * L, "mamba2_ssd_bwd": L, "flash_attention": 2 * inv,
                "flash_attention_bwd": inv}
    return {"flash_attention": 2 * L, "flash_attention_bwd": L}


def family_bwd_kernels(cfg) -> dict:
    """The backward's device kernels and their events in one step."""
    from repro_torch.kernels.flash_attention import BWD_KERNELS as FA
    from repro_torch.kernels.mamba2_ssd import BWD_KERNELS as SSD
    from repro_torch.kernels.rwkv6_wkv import BWD_KERNELS as WKV

    L = cfg.num_layers
    if cfg.family == "rwkv":
        return {k: L for k in WKV}
    if cfg.family == "hybrid":
        return {**{k: L for k in SSD}, **{k: shared_calls(cfg) for k in FA}}
    return {k: L for k in FA}


def decode_step_bytes(cfg, batch: int, cache_len: int = 0) -> dict:
    """The bytes a decode step must move, by part, and their sum
    (``step``): every float32 weight read, and the dense and hybrid KV
    caches of ``cache_len`` positions read (float32); the hybrid's SSM
    states and conv windows, rwkv6's WKV and shift states read and
    written; rwkv6 reads ``batch`` rows of its embedding table, not all of
    it."""
    from repro_torch.models.api import model_specs
    from repro_torch.models.common import param_count

    weights = 4 * param_count(model_specs(cfg))
    L, d = cfg.num_layers, cfg.d_model
    if cfg.family == "rwkv":
        rc = cfg.rwkv_config()
        H, C = rc.num_heads, rc.head_dim
        wkv = L * batch * H * C * C * 4
        shift = 2 * L * batch * d * 4
        step = weights - 4 * cfg.vocab_size * d + 4 * batch * d + 2 * (wkv + shift)
        return {"weights": weights, "wkv": wkv, "shift": shift, "step": step}
    layers = shared_calls(cfg) if cfg.family == "hybrid" else L
    kv = 2 * layers * batch * cfg.num_kv_heads * cache_len * cfg.resolved_head_dim * 4
    if cfg.family != "hybrid":
        return {"weights": weights, "kv": kv, "step": weights + kv}
    m = cfg.mamba_config()
    ssm = L * batch * m.num_heads * m.head_dim * m.d_state * 4
    conv = L * batch * (m.conv_kernel - 1) * (m.d_inner + 2 * m.d_state) * 4
    return {"weights": weights, "kv": kv, "ssm": ssm, "conv": conv,
            "step": weights + kv + 2 * (ssm + conv)}
