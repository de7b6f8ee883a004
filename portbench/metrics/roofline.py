"""What the ``*_roofline`` readers share: a kernel entry's share of its
roofline over the traced window, matched by entry and not by kernel name.

The device time of a call is that of every device event launched inside
the entry: the ``portbench.entry.<name>`` range the benchmark opens around
the models' call of the op in the forward (recomputed forwards included),
and the autograd engine's range of the op's backward node.  The bound of a
call is the larger of its operations at the peak of their precision
(float32 for the scans, bf16 for attention) and its bytes at the HBM's,
counted by the frozen work functions from the call's shapes.
The share is the sum of the bounds over the sum of the device times."""

from portbench.work import peaks


def backward_names(function: str) -> tuple[str, ...]:
    node = f"{function}Backward"
    return (node, f"autograd::engine::evaluate_function: {node}")


def share(ctx, forward: str, backward: tuple[str, ...], fwd_work, bwd_work,
          peak: float = peaks.FP32_FLOPS):
    """100 x sum of bounds / sum of device times, or None without calls."""
    trace = ctx.trace
    if trace is None:
        return None
    fwd = trace.entries((f"portbench.entry.{forward}",))
    bwd = trace.entries(backward) if bwd_work is not None else []
    if not fwd and not bwd:
        return None
    bound = len(fwd) * peaks.bound_seconds(*fwd_work, peak)
    if bwd:
        bound += len(bwd) * peaks.bound_seconds(*bwd_work, peak)
    device_ns = sum(ev.dur for ev in trace.device_in(fwd + bwd))
    if device_ns <= 0:
        return None
    return 100.0 * bound / (device_ns / 1e9)
