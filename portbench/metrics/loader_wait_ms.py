"""loader_wait_ms.train / .score: milliseconds a step of the traced window
spent in the program's ``RSPLoader.next_batch()`` (the benchmark's own
``loader`` span, host clock), the window's total over its steps."""


def read(ctx):
    n = ctx.span_counts.get("loader", 0)
    return 1e3 * ctx.spans["loader"] / ctx.steps if n and ctx.steps else None
