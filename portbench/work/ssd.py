"""Operations and bytes of the Mamba2 SSD scan, forward and backward, from
a call's shapes: xbar ``[B, L, H, P]``, dA ``[B, L, H]``, B and C ``[B, L,
N]``, chunks of Q steps.  Each input is read once and each output written
once, float32.  Frozen here so that every implementation is held to the
same work."""


def ssd_work(B: int, L: int, H: int, P: int = 64, N: int = 64, Q: int = 128) -> tuple[int, int]:
    """(operations, bytes) of one forward: per row and chunk C B^T's causal
    half (shared by the heads), per chunk and head the causal half of the
    intra-chunk product, the inter-chunk term and the state update (2 a
    multiply-add); y and the final state written."""
    nc = -(-L // Q)
    tri = Q * (Q + 1) // 2
    per_head = tri * P + Q * N * P + Q * P * N
    ops = 2 * B * nc * (tri * N + H * per_head)
    nbytes = 4 * (2 * B * L * H * P + B * L * H + 2 * B * L * N + B * H * P * N)
    return ops, nbytes


def ssd_bwd_work(B: int, L: int, H: int, P: int = 64, N: int = 64,
                 Q: int = 128) -> tuple[int, int]:
    """(operations, bytes) of one backward: C B^T's causal half per row and
    chunk; per chunk and head the state gradient's update and three
    chunk-boundary products, and over the causal pairs dy . xbar, the two
    weightings and exponents, three intra-chunk products and the decay's
    path sums; xbar, dy, dA, B, C and the chunk-start states read, dxbar,
    ddA, dB and dC written."""
    nc = -(-L // Q)
    tri = Q * (Q + 1) // 2
    per_head = 4 * 2 * Q * P * N + tri * (2 * P + 2 * P + 2 * N + 2 * N + 6)
    ops = B * nc * (2 * tri * N + H * per_head)
    nbytes = 4 * (3 * B * L * H * P + 2 * B * L * H + 4 * B * L * N + B * nc * H * P * N)
    return ops, nbytes
