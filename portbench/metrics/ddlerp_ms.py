"""ddlerp_ms.score: device milliseconds a call launched inside the program's
``rwkv6.ddlerp`` range: RWKV-6's token shift and data-dependent
interpolation of the five inputs
(``models/rwkv6.py::rwkv6_timemix_apply``) (``program_ranges.py``)."""

from portbench.metrics.program_ranges import DDLERP, range_ms


def read(ctx):
    return range_ms(ctx, DDLERP)
