"""setup_s: seconds from the start of the run's process to the end of its
set-up (the card, the kernels from their cache, weights, corpus and the
warm-up at the cell's shapes), on the host clock."""


def read(ctx):
    return ctx.setup_s
