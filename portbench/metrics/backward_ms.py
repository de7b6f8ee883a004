"""backward_ms.train: device milliseconds a step launched inside the
program's ``train.backward`` range (``loss.backward()`` and the stacking
of the layers' gradients, ``train/loop.py::grads_of``), on its own thread
and on the autograd engine's, less what ``remat_ms.train`` counts
(``program_ranges.py``).  The cross entropy's own chunk recompute counts
here."""

from portbench.metrics.program_ranges import backward_ms


def read(ctx):
    return backward_ms(ctx)
