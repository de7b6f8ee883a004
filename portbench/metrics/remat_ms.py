"""remat_ms.train: device milliseconds a step launched inside the program's
``models.remat`` range: a layer's forward run again in the backward
(``models/transformer.py::_maybe_remat``; the first, forward, call opens
none) (``program_ranges.py``)."""

from portbench.metrics.program_ranges import REMAT, range_ms


def read(ctx):
    return range_ms(ctx, REMAT)
