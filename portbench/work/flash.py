"""Operations and bytes of causal or full softmax attention, forward and
backward, from a call's shapes: q ``[B, H, S, D]``, k and v ``[B, Hkv, S,
D]``, bf16.  Each input is read once and each output written once, at the
unpadded head width.  Frozen here so that every implementation is held to
the same work."""


def _pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def flash_work(B: int, H: int, Hkv: int, S: int, D: int, causal: bool, *, itemsize: int = 2,
               lse: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one forward: QK^T and PV over the attended
    pairs (2 a multiply-add); q, k, v read and the output written, and with
    ``lse`` each row's float32 log-sum-exp written."""
    nbytes = itemsize * (2 * B * H * S * D + 2 * B * Hkv * S * D) + (4 * B * H * S if lse else 0)
    return 4 * B * H * D * _pairs(S, causal), nbytes


def flash_bwd_work(B: int, H: int, Hkv: int, S: int, D: int, causal: bool) -> tuple[int, int]:
    """(operations, bytes) of one backward: 2.5 times the forward's
    products; q, k, v, out, dout read and dq, dk, dv written in bf16, lse
    read in float32."""
    return (10 * B * H * D * _pairs(S, causal),
            2 * D * (4 * B * H * S + 4 * B * Hkv * S) + 4 * B * H * S)
