"""The port's DriftMonitor (Sec.-10 extension) against the reference's.

Each reference test of ``tests/test_drift_monitor.py`` has its counterpart
on the host (``device="cpu"``).  Side by side on the same numpy blocks and
seed, every report equals the reference's: MMD^2, the mean z-score and the
spread ratio within 1e-5 relative to max(|b|, 1) -- MMD^2 is float32 in
both, summed in other orders, and the port computes a block's mean and
spread in float64 where the reference does in float32, so a z-score that is
0 up to rounding (the t block's, whose means are set to the reference's)
is held absolutely -- and the same flags and threshold.
The reference blocks' moments go through the ``block_sketch`` wrapper, one
call a reference block and none per score.
"""

import numpy as np
import pytest
import torch

from repro.core.monitor import DriftMonitor as RefDriftMonitor
from repro_torch import kernels
from repro_torch.core import RSPSpec, two_stage_partition_np
from repro_torch.core.monitor import DriftMonitor
from repro_torch.data import make_higgs_like
from repro_torch.kernels import _sketch
from repro_torch.kernels.block_sketch import ops as sketch_ops
from repro_torch.kernels.block_sketch.kernel import block_sketch_plain

RTOL = 1e-5


def _blocks(seed=0, n=20000, k=20):
    x, _ = make_higgs_like(n, seed=seed)
    spec = RSPSpec(num_records=n, num_blocks=k, num_original_blocks=k, seed=1)
    return two_stage_partition_np(x, spec)


def _monitor(blocks):
    return DriftMonitor(torch.from_numpy(blocks[:5]), seed=0, device="cpu")


def _t_block(blocks):
    rng = np.random.default_rng(7)
    other = rng.standard_t(df=1.5, size=blocks[0].shape).astype(np.float32)
    return other - other.mean(0) + blocks[:5].reshape(-1, blocks.shape[-1]).mean(0)


def _corrupted(blocks):
    bad = blocks[12].copy()
    bad[:, 3] = 0.0  # dead feature (e.g. bad decode of one column)
    return bad


# ---------------------------------------------------------------------------
# The reference's tests, on the host
# ---------------------------------------------------------------------------

def test_clean_blocks_not_flagged():
    blocks = _blocks()
    mon = _monitor(blocks)
    for i in range(5, 15):
        r = mon.score(torch.from_numpy(blocks[i]), block_id=i)
        assert not r.drifted, f"clean block {i} flagged: mmd={r.mmd2}, z={r.max_mean_z}"
    assert mon.drifted_blocks() == []


def test_mean_shifted_block_flagged():
    blocks = _blocks()
    mon = _monitor(blocks)
    r = mon.score(torch.from_numpy(blocks[10] + 1.5), block_id=10)
    assert r.drifted and r.max_mean_z > mon.z_threshold


def test_different_distribution_flagged():
    """Blocks from a 'different data centre' (different covariance) are
    caught by MMD even with matching means."""
    blocks = _blocks()
    mon = _monitor(blocks)
    r = mon.score(torch.from_numpy(_t_block(blocks)), block_id=99)
    assert r.drifted and r.mmd2 > mon.mmd_threshold


def test_corrupted_shard_tripwire():
    blocks = _blocks()
    mon = _monitor(blocks)
    r = mon.score(torch.from_numpy(_corrupted(blocks)), block_id=12)
    assert r.drifted


# ---------------------------------------------------------------------------
# Side by side with the reference
# ---------------------------------------------------------------------------

def _same_report(got, want):
    assert got.block_id == want.block_id and got.drifted == want.drifted
    for field in ("mmd2", "max_mean_z", "worst_std_ratio"):
        g, w = getattr(got, field), getattr(want, field)
        assert abs(g - w) <= RTOL * max(abs(w), 1.0), (field, g, w)


@pytest.mark.parametrize("seed,max_points", [(0, 512), (3, 256)])
def test_reports_match_the_reference(seed, max_points):
    blocks = _blocks()
    ref = RefDriftMonitor(blocks[:5], seed=seed, max_points=max_points)
    mon = DriftMonitor(blocks[:5], seed=seed, max_points=max_points, device="cpu")
    # the threshold is 8 |MMD^2| of the reference sample's halves
    assert abs(mon.mmd_threshold - ref.mmd_threshold) <= RTOL * (1.0 + ref.mmd_threshold)
    incoming = [(i, blocks[i]) for i in range(5, 20)]
    incoming += [(10, blocks[10] + 1.5), (99, _t_block(blocks)), (12, _corrupted(blocks))]
    for bid, block in incoming:
        _same_report(mon.score(torch.from_numpy(block), block_id=bid),
                     ref.score(block, block_id=bid))
    assert mon.drifted_blocks() == ref.drifted_blocks() == [10, 99, 12]


def test_explicit_thresholds_match_the_reference():
    blocks = _blocks(seed=4)
    kw = dict(mmd_threshold=0.02, z_threshold=3.0, std_ratio_threshold=1.2, seed=1)
    ref = RefDriftMonitor(blocks[:3], **kw)
    mon = DriftMonitor(blocks[:3], device="cpu", **kw)
    for i in range(3, 20):
        _same_report(mon.score(blocks[i], block_id=i), ref.score(blocks[i], block_id=i))
    assert mon.drifted_blocks() == ref.drifted_blocks()


def test_reference_blocks_go_through_the_sketch_wrapper(monkeypatch):
    """The reference blocks' moments reach ``block_sketch_packed`` (the
    kernel's launcher on the card) once a block; scoring calls no kernel.
    On the host the launcher is swapped for a counting plain stand-in."""
    calls = []

    def stand_in(x, lo, inv_width, *, bins, config=None):
        calls.append(tuple(x.shape))
        stats, hist = block_sketch_plain(x, lo, inv_width, bins=bins)
        return _sketch.pack(stats, hist, torch.zeros(1, dtype=torch.int64))

    blocks = _blocks()
    plain = _monitor(blocks)            # the plain version's moments
    real_resolve = sketch_ops.resolve_impl
    monkeypatch.setattr(sketch_ops, "resolve_impl",
                        lambda impl, x: "cuda" if impl == "auto" else real_resolve(impl, x))
    monkeypatch.setattr(sketch_ops, "block_sketch_packed", stand_in)
    kernels.reset_launch_counts()
    mon = _monitor(blocks)
    assert calls == [(1000, 28)] * 5
    for i in (5, 6):
        _same_report(mon.score(blocks[i], block_id=i), plain.score(blocks[i], block_id=i))
    assert len(calls) == 5
    assert sum(kernels.launch_counts().values()) == 0


def test_monitor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CPU-only behaviour does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DriftMonitor(np.zeros((2, 10, 3), np.float32))
