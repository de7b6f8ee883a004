"""step_mfu.train / .score: the least time of a step's model operations
at the H100's published peaks over the step's time, in %.  The operations
are the frozen counts of ``portbench/work/model_ops.py`` (training: before
remat, no recomputed work; scoring: every position unembedded and each
WKV forward), bf16 ones at the bf16 peak and float32 ones at the float32
peak.  The step's time is the traced window over its steps."""

from portbench.work import model_ops, peaks


def read(ctx):
    if ctx.trace is None or not ctx.steps:
        return None
    t = ctx.workload["traffic"]
    B, S = t["batch"], t["length"] - 1
    kind = ctx.metric.split(".", 1)[1]
    if kind == "train":
        bf16, f32 = model_ops.train_ops(ctx.config, B, S)
    elif kind == "score" and ctx.config["family"] == "rwkv":
        bf16, f32 = model_ops.rwkv_score_ops(ctx.config, B, S)
    else:
        return None
    return 100.0 * peaks.least_seconds(bf16, f32) / (ctx.trace.window_s / ctx.steps)
