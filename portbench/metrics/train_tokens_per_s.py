"""train_tokens_per_s: every token of every training step completed in the
window over the window's seconds (host clock; the window ends at a
synchronize after the last step)."""


def read(ctx):
    return ctx.work / ctx.elapsed if ctx.steps else None
