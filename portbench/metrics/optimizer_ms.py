"""optimizer_ms.train: device milliseconds a step launched inside the
program's ``train.optimizer`` range: the learning-rate schedule and
AdamW's update (``train/loop.py``, both step functions)
(``program_ranges.py``)."""

from portbench.metrics.program_ranges import OPTIMIZER, range_ms


def read(ctx):
    return range_ms(ctx, OPTIMIZER)
