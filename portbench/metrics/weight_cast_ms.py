"""weight_cast_ms.score: device milliseconds a call launched inside the
program's ``models.weight_cast`` range: the narrowing casts of float32
weights to the compute dtype in ``models/common.py``'s ``linear`` and
``unembed_logits`` (``program_ranges.py``)."""

from portbench.metrics.program_ranges import WEIGHT_CAST, range_ms


def read(ctx):
    return range_ms(ctx, WEIGHT_CAST)
