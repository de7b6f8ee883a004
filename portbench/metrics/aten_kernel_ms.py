"""aten_kernel_ms.train / .score: device milliseconds a step in PyTorch's
own ATen kernels (device kernels whose names hold ``at::native``): the
elementwise operations, casts, reductions and copies the models run
eagerly, from the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    ns = sum(ev.dur for ev in ctx.trace.device if "at::native" in ev.name)
    return ns / 1e6 / ctx.steps
