"""Model operations of a training step or a scoring pass, from the
configuration's sizes (the ``run`` object of a configuration file): every
projection over every token (2 operations a multiply-add), attention over
its causal pairs, the unembedding at every position, and the scans' work
(``wkv.py``, ``ssd.py``).  A training step counts the forward three times
and no recomputed work.  Frozen here so that every implementation is held
to the same work."""

from portbench.work.ssd import ssd_bwd_work, ssd_work
from portbench.work.wkv import wkv_bwd_work, wkv_work


def shared_calls(cfg: dict) -> int:
    """The hybrid's calls of its shared block in one pass."""
    period = cfg["attn_every"]
    return -(-cfg["num_layers"] // period)


def rwkv_flops(cfg: dict, batch: int, seq: int, every_position: bool) -> tuple[int, int]:
    """(bf16, float32) operations of a pass over ``batch x seq`` tokens:
    the bf16 projections (r, k, v, g, o; the channel mix's key, value and
    receptance) and the unembedding of every position or of the last; the
    float32 low-rank products of the ddlerp and the decay."""
    d, f, r = cfg["d_model"], cfg["d_ff"], cfg.get("lora_rank", 32)
    matrix = 6 * d * d + 2 * d * f
    lora = 10 * d * r + 2 * d * r
    tokens = batch * seq
    bf16 = 2 * cfg["num_layers"] * matrix * tokens + 2 * d * cfg["vocab_size"] * (
        tokens if every_position else batch)
    return bf16, 2 * cfg["num_layers"] * lora * tokens


def rwkv_score_ops(cfg: dict, batch: int, seq: int) -> tuple[int, int]:
    """(bf16, float32) operations of a scoring pass: every position
    unembedded, and each layer's WKV forward."""
    bf16, f32 = rwkv_flops(cfg, batch, seq, every_position=True)
    H = cfg["d_model"] // cfg.get("rwkv_head_dim", 64)
    return bf16, f32 + cfg["num_layers"] * wkv_work(batch, seq, H, cfg.get("rwkv_head_dim", 64))[0]


def train_ops(cfg: dict, batch: int, seq: int) -> tuple[int, int]:
    """(bf16, float32) operations of a training step before remat."""
    d, T, L = cfg["d_model"], batch * seq, cfg["num_layers"]
    if cfg["family"] == "rwkv":
        bf16, f32 = rwkv_flops(cfg, batch, seq, every_position=True)
        C = cfg.get("rwkv_head_dim", 64)
        H = d // C
        scan = L * (wkv_work(batch, seq, H, C)[0] + wkv_bwd_work(batch, seq, H, C)[0])
        return 3 * bf16, 3 * f32 + scan
    if cfg["family"] != "hybrid":
        raise ValueError(f"no operation count for family {cfg['family']!r}")
    heads = cfg["num_heads"]
    dh = d // heads
    proj = d * dh * 4 * heads
    attn = 4 * heads * dh * seq * (seq + 1) // 2 * batch
    ends = 2 * d * cfg["vocab_size"] * T
    di = cfg.get("ssm_expand", 2) * d
    N, P = cfg["ssm_state"], cfg.get("ssm_head_dim", 64)
    H = di // P
    shared = 2 * d * d + proj + 3 * d * cfg["d_ff"]
    mamba = d * (2 * di + 2 * N) + di * d
    bf16 = shared_calls(cfg) * (2 * shared * T + attn) + L * 2 * mamba * T + ends
    Q = cfg.get("ssm_chunk", 128)
    scan = L * (ssd_work(batch, seq, H, P, N, Q)[0] + ssd_bwd_work(batch, seq, H, P, N, Q)[0])
    return 3 * bf16, 3 * L * 2 * d * H * T + scan
