"""forward_ms.train: device milliseconds a step launched inside the program's
``train.forward`` range: the model's build and its loss
(``train/loop.py::grads_of``), once each microbatch
(``program_ranges.py``)."""

from portbench.metrics.program_ranges import FORWARD, range_ms


def read(ctx):
    return range_ms(ctx, FORWARD)
