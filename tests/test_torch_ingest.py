"""The port's out-of-core ingest (``repro_torch.rsp.ingest`` and the
``np_stream`` backend) against the reference package's.

The same inputs, made from a seed with numpy, stream through both
packages' ``stream_partition``: the blocks must be bit-identical to each
other and to ``two_stage_partition_np`` for every chunking, and the
sketches folded during the scatter must be equal field for field (both fold
in float64 with the same numpy code, in the same order).  Stores written by
either package open in the other with identical block files and
``sketches.json``.  Everything runs on the CPU (``device="cpu"``).
"""

import json
import os

import numpy as np
import pytest
import torch

from repro import rsp as ref_rsp
from repro.core import RSPSpec as RefSpec
from repro.core import two_stage_partition_np as ref_two_stage
from repro.rsp import ingest as ref_ingest
from repro_torch import obs, rsp
from repro_torch.core.partition import two_stage_partition_np
from repro_torch.core.types import RSPSpec
from repro_torch.rsp import ingest
from repro_torch.rsp.backends import PartitionRequest, run_partition, select_backend
from repro_torch.rsp.ingest import (
    ArrayChunkSource,
    DirectoryChunkSource,
    IterChunkSource,
    NpyChunkSource,
    as_chunk_source,
    is_stream_source,
    stream_partition,
)
from repro_torch.rsp.summaries import summarize_blocks

CPU = torch.device("cpu")
CUDA = torch.device("cuda")   # a device name only: no test here touches a card
N, F, P, K = 480, 4, 4, 4     # R = 120 records an original block
R = N // P


def _data(n=N, f=F, seed=0, num_classes=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    if num_classes:
        x[:, -1] = rng.integers(0, num_classes, size=n)
    return x


def _spec(n=N, k=K, p=P, seed=3, f=F):
    return RSPSpec(num_records=n, num_blocks=k, num_original_blocks=p,
                   record_shape=(f,), dtype="float32", seed=seed)


def _ref_spec(spec):
    return RefSpec(num_records=spec.num_records, num_blocks=spec.num_blocks,
                   num_original_blocks=spec.num_original_blocks,
                   record_shape=spec.record_shape, dtype=spec.dtype, seed=spec.seed)


def _same_suites(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_dict() == w.to_dict()


# ---------------------------------------------------------------------------
# Bit for bit: the port's scatter, the reference's and two_stage_partition_np
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("permute", [True, False], ids=["assign", "no-assign"])
@pytest.mark.parametrize("workers", [0, 4])
@pytest.mark.parametrize("chunk", [1, 7, R - 1, R + 1, N], ids=lambda c: f"chunk{c}")
def test_stream_partition_matches_the_reference_bit_for_bit(chunk, workers, permute):
    data = _data()
    spec = _spec()
    got, suites = stream_partition(
        ArrayChunkSource(data, chunk_records=chunk), spec, workers=workers,
        permute_assignment=permute, num_classes=2,
    )
    want, ref_suites = ref_ingest.stream_partition(
        ref_ingest.ArrayChunkSource(data, chunk_records=chunk), _ref_spec(spec),
        workers=workers, permute_assignment=permute, num_classes=2,
    )
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, two_stage_partition_np(data, spec, permute_assignment=permute))
    np.testing.assert_array_equal(
        got, ref_two_stage(data, _ref_spec(spec), permute_assignment=permute))
    _same_suites(suites, ref_suites)


def test_stream_partition_of_scalar_records():
    data = np.random.default_rng(1).normal(size=(640,))
    spec = RSPSpec(num_records=640, num_blocks=4, num_original_blocks=4,
                   record_shape=(), dtype="float64", seed=5)
    got, _ = stream_partition(ArrayChunkSource(data, chunk_records=99), spec)
    np.testing.assert_array_equal(got, two_stage_partition_np(data, spec))


def test_folded_sketches_match_a_full_summarize():
    """The reference's own tolerances (``tests/test_ingest.py``) against a
    post-hoc summary of the finished blocks."""
    data = _data(1920)
    spec = _spec(1920, k=8, p=4)
    blocks, suites = stream_partition(ArrayChunkSource(data, chunk_records=333), spec,
                                      num_classes=2)
    exact = summarize_blocks(blocks, label_column=-1, num_classes=2)
    for s, e in zip(suites, exact):
        assert s.count == e.count
        np.testing.assert_allclose(s.mean, e.mean, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(s.m2, e.m2, rtol=1e-7, atol=1e-9)
        np.testing.assert_array_equal(s.min, e.min)
        np.testing.assert_array_equal(s.max, e.max)
        np.testing.assert_array_equal(s.label_hist, e.label_hist)


def test_labels_outside_the_classes_abort_the_scatter():
    data = _data()
    data[5, -1] = 7
    with pytest.raises(ValueError, match="label column"):
        stream_partition(ArrayChunkSource(data), _spec(), num_classes=2)


# ---------------------------------------------------------------------------
# ChunkSource adapters
# ---------------------------------------------------------------------------

def _write_chunks(root, data, cuts=(0, 131, 300, N)):
    root.mkdir()
    for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
        np.save(root / f"part_{i:03d}.npy", data[a:b])


def _adapter(kind, data, tmp_path):
    if kind == "array":
        return ArrayChunkSource(data, chunk_records=50), ref_ingest.ArrayChunkSource(
            data, chunk_records=50)
    if kind == "tensor":
        return ArrayChunkSource(torch.from_numpy(data), chunk_records=50), \
            ref_ingest.ArrayChunkSource(data, chunk_records=50)
    if kind == "npy":
        np.save(tmp_path / "c.npy", data)
        path = str(tmp_path / "c.npy")
        return NpyChunkSource(path, chunk_records=70), ref_ingest.NpyChunkSource(
            path, chunk_records=70)
    if kind == "directory":
        _write_chunks(tmp_path / "chunks", data)
        path = str(tmp_path / "chunks")
        return DirectoryChunkSource(path), ref_ingest.DirectoryChunkSource(path)
    if kind == "iter":
        batches = [data[a:a + 90] for a in range(0, N, 90)]
        return (IterChunkSource(iter(batches), num_records=N, record_shape=(F,),
                                dtype=np.float32),
                ref_ingest.IterChunkSource(iter(batches), num_records=N, record_shape=(F,),
                                           dtype=np.float32))
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["array", "tensor", "npy", "directory", "iter"])
def test_adapters_stream_what_the_reference_streams(kind, tmp_path):
    data = _data()
    src, ref_src = _adapter(kind, data, tmp_path)
    assert (src.num_records, tuple(src.record_shape), np.dtype(src.dtype)) == \
        (ref_src.num_records, tuple(ref_src.record_shape), np.dtype(ref_src.dtype))
    assert (src.num_records, tuple(src.record_shape)) == (N, (F,))
    got, _ = stream_partition(src, _spec(), num_classes=2)
    want, _ = ref_ingest.stream_partition(ref_src, _ref_spec(_spec()), num_classes=2)
    np.testing.assert_array_equal(got, want)


def test_as_chunk_source_adapts_paths_directories_and_batch_lists(tmp_path):
    data = _data()
    np.save(tmp_path / "c.npy", data)
    _write_chunks(tmp_path / "chunks", data)
    assert isinstance(as_chunk_source(str(tmp_path / "c.npy")), NpyChunkSource)
    assert isinstance(as_chunk_source(tmp_path / "chunks"), DirectoryChunkSource)
    batches = as_chunk_source([data[:100], data[100:]])
    assert isinstance(batches, IterChunkSource)
    np.testing.assert_array_equal(np.concatenate(list(batches.chunks())), data)
    np.testing.assert_array_equal(np.concatenate(list(batches.chunks())), data)  # re-iterable
    with pytest.raises(TypeError, match="neither"):
        as_chunk_source(str(tmp_path / "missing.npy"))
    with pytest.raises(TypeError, match="cannot build"):
        as_chunk_source(object())


def test_one_shot_iterator_streams_once_and_declares_its_shape():
    src = IterChunkSource(iter([np.zeros((4, 2), np.float32)]), num_records=4,
                          record_shape=(2,), dtype=np.float32)
    list(src.chunks())
    with pytest.raises(RuntimeError, match="already"):
        list(src.chunks())
    with pytest.raises(ValueError, match="up front"):
        IterChunkSource(iter([]))


def test_directory_of_mismatched_chunks_is_refused(tmp_path):
    d = tmp_path / "chunks"
    d.mkdir()
    np.save(d / "a.npy", np.zeros((4, 3), np.float32))
    np.save(d / "b.npy", np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="expected"):
        DirectoryChunkSource(str(d))


@pytest.mark.parametrize("workers", [1, 4])
def test_buffer_reusing_producer_is_safe(workers):
    """A source that yields the SAME buffer every batch must not corrupt
    the partition: the scatter workers read a segment after the producer
    has overwritten the buffer (``tests/test_ingest.py``'s case)."""
    data = _data(1920)
    spec = _spec(1920, k=8, p=4)

    def reused_buffer_batches():
        buf = np.empty((120, F), dtype=np.float32)
        for a in range(0, 1920, 120):
            buf[:] = data[a:a + 120]
            yield buf

    src = IterChunkSource(reused_buffer_batches(), num_records=1920, record_shape=(F,),
                          dtype=np.float32)
    got, _ = stream_partition(src, spec, workers=workers)
    np.testing.assert_array_equal(got, two_stage_partition_np(data, spec))


# ---------------------------------------------------------------------------
# Direct-to-store ingest: atomic publish, and stores shared by both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("failure", ["source died", "short source"])
def test_abort_mid_ingest_publishes_nothing_and_reingest_succeeds(failure, tmp_path):
    data = _data()
    spec = _spec()
    out = str(tmp_path / "rsp")

    def exploding_chunks():
        for a in range(0, N, 60):
            if a >= 240:
                raise RuntimeError("source died mid-stream")
            yield data[a:a + 60]

    if failure == "source died":
        src = IterChunkSource(exploding_chunks(), num_records=N, record_shape=(F,),
                              dtype=np.float32)
        err = (RuntimeError, "died mid-stream")
    else:
        src = IterChunkSource([data[:N // 2]])
        src._num_records = N   # promises more records than it yields
        err = (ValueError, str(N))
    with pytest.raises(err[0], match=err[1]):
        stream_partition(src, spec, out=out, num_classes=2)
    assert not os.path.exists(os.path.join(out, "manifest.json"))
    assert [f for f in os.listdir(out) if f.endswith(".tmp.npy")] == []
    with pytest.raises(FileNotFoundError):
        rsp.open(out, device="cpu")
    store, _ = stream_partition(ArrayChunkSource(data, chunk_records=60), spec, out=out)
    ref = two_stage_partition_np(data, spec)
    for k in range(K):
        np.testing.assert_array_equal(np.asarray(store.load_block(k, verify=True)), ref[k])


def _file_bytes(root):
    return {n: (root / n).read_bytes() for n in sorted(os.listdir(root))
            if n.startswith("block_") or n == "sketches.json"}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ingested_store_opens_in_the_other_package(writer, tmp_path):
    """A store ingested by either package has the other's block files and
    ``sketches.json`` byte for byte, and opens in the other with the same
    blocks and sketches."""
    data = _data(1920, f=6)
    np.save(tmp_path / "c.npy", data)
    path = str(tmp_path / "c.npy")
    kw = dict(blocks=8, original_blocks=4, seed=9, num_classes=2, chunk_records=250)
    port = rsp.from_source(path, out=str(tmp_path / "port"), device="cpu", **kw)
    ref = ref_rsp.from_source(path, out=str(tmp_path / "ref"), **kw)
    assert port.backend == ref.backend == "np_stream"
    assert _file_bytes(tmp_path / "port") == _file_bytes(tmp_path / "ref")
    port_meta = json.loads((tmp_path / "port" / "manifest.json").read_text())
    ref_meta = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    assert port_meta == ref_meta

    root = str(tmp_path / ("port" if writer == "port" else "ref"))
    mine = rsp.open(root, device="cpu")
    theirs = ref_rsp.open(root)
    assert mine.backend == theirs.backend == "np_stream" and mine.num_classes == 2
    for k in range(8):
        np.testing.assert_array_equal(mine.block(k).numpy(), np.asarray(theirs.block(k)))
    _same_suites(mine.summaries, theirs.summaries)
    _same_suites(port.summaries, ref.summaries)
    mine.close()
    theirs.close()
    port.close()
    ref.close()


def test_ingest_counts_its_chunks_and_rows_when_telemetry_is_on(tmp_path):
    obs.reset()
    obs.enable()
    try:
        stream_partition(ArrayChunkSource(_data(), chunk_records=100), _spec(),
                         out=str(tmp_path / "rsp"))
        snap = obs.get_registry().snapshot()
    finally:
        obs.disable()
        obs.reset()

    def series(name):
        (one,) = snap[name]["series"]
        assert one["labels"] == {"sink": "store"}
        return one

    assert series("rsp_ingest_chunks_total")["value"] == N // 100 + 1
    assert series("rsp_ingest_rows_scattered_total")["value"] == N
    assert series("rsp_ingest_chunk_seconds")["count"] == N // 100 + 1
    assert series("rsp_ingest_rows_per_second")["value"] > 0


# ---------------------------------------------------------------------------
# The np_stream backend: auto's choices, as the reference makes them
# ---------------------------------------------------------------------------

def _chosen(data, device, **kw):
    return select_backend(PartitionRequest(data=data, spec=_spec(), device=device, **kw)).name


def test_auto_streams_paths_memmaps_and_out_writes(tmp_path):
    data = _data()
    np.save(tmp_path / "c.npy", data)
    npy = as_chunk_source(str(tmp_path / "c.npy"))
    mm = np.load(tmp_path / "c.npy", mmap_mode="r")
    out = str(tmp_path / "s")
    for device in (CPU, CUDA):
        assert _chosen(npy, device) == "np_stream"
        assert _chosen(mm, device) == "np_stream"
        assert _chosen(data, device, out=out) == "np_stream"
        assert _chosen(torch.from_numpy(data), device, out=out) == "np_stream"
    # in-memory arrays without out= keep the in-memory paths: the kernel on
    # a CUDA device, numpy on the host -- the reference's np for both
    assert _chosen(data, CPU) == "np"
    assert _chosen(torch.from_numpy(data), CPU) == "np"
    assert _chosen(data, CUDA) == "cuda"
    ref_spec = _ref_spec(_spec())
    ref_choice = ref_rsp.select_backend
    assert ref_choice(ref_rsp.PartitionRequest(data=ref_ingest.as_chunk_source(
        str(tmp_path / "c.npy")), spec=ref_spec)).name == "np_stream"
    assert ref_choice(ref_rsp.PartitionRequest(data=data, spec=ref_spec, out=out)).name == \
        "np_stream"
    assert ref_choice(ref_rsp.PartitionRequest(data=mm, spec=ref_spec)).name == "np_stream"


def test_in_memory_backends_refuse_stream_sources_with_a_reason(tmp_path):
    np.save(tmp_path / "c.npy", _data())
    src = as_chunk_source(str(tmp_path / "c.npy"))
    reasons = rsp.backend_eligibility(PartitionRequest(data=src, spec=_spec(), device=CPU))
    assert reasons["np_stream"] is None
    for name in ("np", "cuda"):
        assert "np_stream" in reasons[name]
    empty = tmp_path / "empty"
    empty.mkdir()
    reasons = rsp.backend_eligibility(
        PartitionRequest(data=str(empty), spec=_spec(), device=CPU))
    assert "not chunkable" in reasons["np_stream"]
    with pytest.raises(ValueError, match="no .npy chunk files"):
        rsp.partition(str(empty), blocks=4, device="cpu")


def test_stream_source_classification(tmp_path):
    arr = np.zeros((8, 2), np.float32)
    np.save(tmp_path / "c.npy", arr)
    assert not is_stream_source(arr)
    assert not is_stream_source(torch.zeros(8, 2))
    assert not is_stream_source([arr])
    assert is_stream_source(str(tmp_path / "c.npy"))
    assert is_stream_source(np.load(tmp_path / "c.npy", mmap_mode="r"))
    assert not is_stream_source(object())


def test_run_partition_resolves_a_path_source_once(tmp_path, monkeypatch):
    data = _data()
    np.save(tmp_path / "c.npy", data)
    calls = []
    orig = ingest.NpyChunkSource.__init__

    def counting(self, path, **kw):
        calls.append(path)
        orig(self, path, **kw)

    monkeypatch.setattr(ingest.NpyChunkSource, "__init__", counting)
    result, chosen = run_partition(
        PartitionRequest(data=str(tmp_path / "c.npy"), spec=_spec(), device=CPU))
    assert chosen == "np_stream" and len(calls) == 1
    assert isinstance(result, torch.Tensor) and result.device == CPU
    np.testing.assert_array_equal(result.numpy(), two_stage_partition_np(data, _spec()))


# ---------------------------------------------------------------------------
# The facade: partition(path, out=), partition(array, out=), from_source
# ---------------------------------------------------------------------------

def test_partition_of_a_path_writes_a_store_with_folded_sketches(tmp_path):
    data = _data(1920, f=6)
    np.save(tmp_path / "c.npy", data)
    ds = rsp.partition(str(tmp_path / "c.npy"), blocks=8, seed=21, num_classes=2,
                       out=str(tmp_path / "st"), device="cpu")
    ref = ref_rsp.partition(data, blocks=8, seed=21, num_classes=2)
    assert ds.backend == "np_stream" and ds.store is not None and ds.has_summaries
    assert ds.device == CPU and ds.block(0).device == CPU
    np.testing.assert_array_equal(ds.take(range(8)).numpy(), ref.stacked())
    reopened = rsp.open(str(tmp_path / "st"), device="cpu")
    assert reopened.backend == "np_stream" and reopened.num_classes == 2
    _same_suites(reopened.summaries, ds.summaries)
    for s, e in zip(ds.summaries, ref.summaries):
        np.testing.assert_allclose(s.mean, e.mean, rtol=1e-9, atol=1e-11)
        np.testing.assert_array_equal(s.label_hist, e.label_hist)
    ds.close()
    reopened.close()


def test_partition_of_an_array_with_out_streams_like_the_reference(tmp_path):
    data = _data(1920, f=6)
    ds = rsp.partition(data, blocks=8, seed=4, num_classes=2, out=str(tmp_path / "port"),
                       device="cpu")
    ref = ref_rsp.partition(data, blocks=8, seed=4, num_classes=2, out=str(tmp_path / "ref"))
    assert ds.backend == ref.backend == "np_stream"
    assert _file_bytes(tmp_path / "port") == _file_bytes(tmp_path / "ref")
    ds.close()
    ref.close()


def test_from_source_forces_streaming_for_an_array_without_a_store():
    data = _data(1920)
    spec = _spec(1920, k=8, p=8, seed=21)
    ds = rsp.from_source(data, blocks=8, seed=21, chunk_records=217, device="cpu")
    assert ds.backend == "np_stream" and ds.store is None
    np.testing.assert_array_equal(ds.stacked().numpy(), two_stage_partition_np(data, spec))
    # the sketches come from the in-memory blocks, as every in-memory backend's
    _same_suites(ds.summaries, ref_rsp.from_source(data, blocks=8, seed=21).summaries)


def test_streamed_sketch_query_reads_no_block(tmp_path):
    data = _data(4096, f=6, seed=8, num_classes=0)
    np.save(tmp_path / "c.npy", data)
    ds = rsp.from_source(str(tmp_path / "c.npy"), blocks=16, out=str(tmp_path / "st"), seed=2,
                         device="cpu")
    before = ds.executor.stats()
    res = ds.query(["mean", "count"])
    assert res.from_sketches and (ds.executor.stats() - before).blocks_fetched == 0
    np.testing.assert_allclose(res["mean"].estimate, data.mean(axis=0, dtype=np.float64),
                               atol=1e-6)
    assert float(res["count"].estimate) == 4096
    ds.close()
