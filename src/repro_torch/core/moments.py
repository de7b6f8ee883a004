"""The one Chan et al. parallel moment-combine.

Every layer that folds per-block moments -- ``core.estimators``, the
``block_sketch`` reference and plain versions, and the ``rsp.sketch`` suite
-- routes through :func:`chan_merge` so the algebra lives in one place.
The helper works on Python floats, numpy arrays and torch tensors alike
and operates on the raw ``(count, mean, m2)`` triple, so callers can wrap
the result in whatever container they use.  (The CUDA kernels carry the
same algebra in ``csrc/sketch_common.cuh``.)
"""

from __future__ import annotations

import numpy as np
import torch


def chan_merge(count_a, mean_a, m2_a, count_b, mean_b, m2_b):
    """Combine two (count, mean, M2) moment triples exactly.

    Chan et al.'s parallel update: order-independent and numerically stable
    for the block-fold sizes used here.  Returns ``(count, mean, m2)``.  The
    count guard makes the empty+empty merge well-defined (returns zeros)
    instead of dividing by zero.
    """
    n = count_a + count_b
    if isinstance(n, torch.Tensor):
        safe_n = torch.clamp(n, min=1.0)
    else:
        safe_n = np.maximum(n, 1.0)
    delta = mean_b - mean_a
    mean = mean_a + delta * (count_b / safe_n)
    m2 = m2_a + m2_b + delta * delta * (count_a * count_b / safe_n)
    return n, mean, m2
