"""Operations and bytes of the RWKV6 WKV recurrence, forward and backward,
from a call's shapes: r, k, v, logw ``[B, T, H, C]``, u ``[H, C]``, chunks of
Q steps.  Each input is read once and each output written once, float32.
Frozen here so that every implementation is held to the same work."""


def wkv_work(B: int, T: int, H: int, C: int = 64, Q: int = 16) -> tuple[int, int]:
    """(operations, bytes) of one forward: per (row, head, chunk) the prefix
    sums, the two decayed operands, the pairwise weights over the strictly
    lower pairs (5 operations a channel), the bonus, the inter-chunk
    product, the intra-chunk sum and the state update (2 a multiply-add);
    y and the final state written."""
    nc = -(-T // Q)
    pairs = Q * (Q - 1) // 2
    per_chunk = (Q * C + 5 * Q * C + C + 5 * pairs * C + 3 * Q * C
                 + 2 * Q * C * C + 2 * pairs * C + 3 * Q * C
                 + 2 * Q * C * C + 2 * C * C)
    ops = B * H * nc * per_chunk
    nbytes = 4 * (5 * B * T * H * C + H * C + B * H * C * C)
    return ops, nbytes


def wkv_bwd_work(B: int, T: int, H: int, C: int = 64, Q: int = 16) -> tuple[int, int]:
    """(operations, bytes) of one backward: per (row, head, chunk) four
    [Q, C] x [C, C] products, the pairwise terms of dr, dk, dv and dlogw's
    path sums, and the elementwise terms; r, k, v, logw, dy and the
    chunk-start states read, dr, dk, dv, dlogw and du written."""
    nc = -(-T // Q)
    pairs = Q * (Q - 1) // 2
    per_chunk = 8 * Q * C * C + 2 * Q * Q * C + pairs * C * 17 + 12 * Q * C
    ops = B * H * nc * per_chunk
    nbytes = 4 * (9 * B * T * H * C + B * nc * H * C * C + 2 * H * C)
    return ops, nbytes
