"""Stored RSPs are shared: a store written by either package opens in the
other with identical blocks and sketches, and both write the same bytes."""

import os

import numpy as np
import torch

from repro import rsp as ref_rsp
from repro.core.registry import RSPStore as RefStore
from repro_torch import rsp
from repro_torch.core.registry import RSPStore
from repro_torch.core.types import RSPSpec

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "v1_store")


def _corpus(n=2400, f=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    x[:, -1] = np.sort(rng.integers(0, 2, size=n))  # class-sorted labels
    return x


def _suite_dicts(ds):
    return [s.to_dict() for s in ds.summaries]


def test_reference_store_opens_in_port(tmp_path):
    data = _corpus()
    ref = ref_rsp.partition(data, blocks=5, seed=3, num_classes=2, backend="np")
    ref.save(str(tmp_path))
    ds = rsp.open(str(tmp_path), device="cpu")
    assert ds.spec == RSPSpec.from_json(ref.spec.to_json())
    assert ds.num_classes == 2 and ds.label_column == -1
    np.testing.assert_array_equal(ds.stacked().numpy(), np.asarray(ref.stacked()))
    assert _suite_dicts(ds) == _suite_dicts(ref)
    for mode in ("store", "mmap", "memory"):
        other = rsp.open(str(tmp_path), device="cpu", fetcher=mode)
        assert torch.equal(other.block(4), torch.from_numpy(np.array(ref.block(4))))


def test_port_store_opens_in_reference(tmp_path):
    data = _corpus(seed=1)
    ds = rsp.partition(data, blocks=5, seed=4, num_classes=2, backend="cuda", device="cpu")
    ds.save(str(tmp_path))
    ref = ref_rsp.open(str(tmp_path))
    assert ref.backend == "cuda"
    np.testing.assert_array_equal(np.asarray(ref.stacked()), ds.stacked().numpy())
    assert _suite_dicts(ref) == _suite_dicts(ds)
    assert RefStore(str(tmp_path)).load_block(2, verify=True).shape == (480, 5)


def test_both_packages_write_the_same_bytes(tmp_path):
    data = _corpus(seed=2)
    ref_rsp.partition(data, blocks=4, seed=5, num_classes=2, backend="np").save(
        str(tmp_path / "ref"))
    rsp.partition(data, blocks=4, seed=5, num_classes=2, backend="np", device="cpu").save(
        str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert "sketches.json" in names and "manifest.json" in names
    for name in names:
        a = (tmp_path / "ref" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b, name


def test_v1_fixture_opens_in_port():
    ds = rsp.open(FIXTURE, device="cpu")
    ref = ref_rsp.open(FIXTURE)
    assert ds.num_blocks == 4
    np.testing.assert_array_equal(ds.stacked().numpy(), np.asarray(ref.stacked()))
    assert _suite_dicts(ds) == _suite_dicts(ref)
    m, r = ds.moments(), ref.moments()
    np.testing.assert_array_equal(m.mean, r.mean)
    np.testing.assert_array_equal(m.m2, r.m2)
    for i in range(4):
        RSPStore(FIXTURE).load_block(i, verify=True)


def test_store_sweeps_stale_blocks_and_temps(tmp_path):
    spec6 = RSPSpec(num_records=36, num_blocks=6, num_original_blocks=6, record_shape=(2,))
    store = RSPStore(str(tmp_path))
    store.write_partition(torch.zeros((6, 6, 2)), spec6)
    (tmp_path / "block_00001.npy.tmp.npy").write_bytes(b"orphan")
    spec3 = RSPSpec(num_records=36, num_blocks=3, num_original_blocks=3, record_shape=(2,))
    store.write_partition(np.ones((3, 12, 2), np.float32), spec3)
    assert sorted(os.listdir(tmp_path)) == [
        "block_00000.npy", "block_00001.npy", "block_00002.npy", "manifest.json"]
    assert store.num_blocks() == 3 and store.spec() == spec3
    np.testing.assert_array_equal(RefStore(str(tmp_path)).load_block(2), np.ones((12, 2)))


def test_partition_writer_publishes_atomically(tmp_path):
    spec = RSPSpec(num_records=20, num_blocks=2, num_original_blocks=2, record_shape=(3,))
    store = RSPStore(str(tmp_path))
    w = store.create_writer(spec)
    assert not (tmp_path / "manifest.json").exists()
    vals = np.arange(60, dtype=np.float32).reshape(2, 10, 3)
    for k in range(2):
        w.write_rows(k, np.arange(10), vals[k])
    w.finalize()
    ref = RefStore(str(tmp_path))
    for k in range(2):
        np.testing.assert_array_equal(ref.load_block(k, verify=True), vals[k])
    w2 = store.create_writer(spec)
    w2.abort()
    assert not any(p.endswith(".tmp.npy") for p in os.listdir(tmp_path))
