"""Assigned input-shape cells (LM-family): seq_len x global_batch.

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``.  ``long_500k`` requires
sub-quadratic context handling and runs only for SSM/hybrid archs;
encoder-only archs have no decode shapes.  Applicability is resolved in
``repro.configs.cells()``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeCell("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeCell("long_500k", "decode", 524288, 1),
}
