"""The port's RSP training loader and ``BlockExecutor.stream_batches``
against the reference package's.

Each loader test of ``tests/test_registry_loader.py`` (and the
``stream_batches`` / ``ds.loader`` tests of ``tests/test_engine.py`` and
``tests/test_rsp_dataset.py``) has its counterpart on host tensors.  Side by
side over one store, the port's batches equal the reference's bit for bit
(the same blocks in the same order, permuted by the same numpy draws), a
``state_dict`` saved by either package -- v2, or a legacy v1 -- resumes in
the other with the same next batches, and ``ds.deal`` deals the same
blocks.
"""

import numpy as np
import pytest
import torch

from repro import rsp as ref_rsp
from repro.data import loader as ref_loader
from repro.rsp.engine import BlockExecutor as RefExecutor
from repro.rsp.engine import StoreFetcher as RefStoreFetcher
from repro_torch import rsp
from repro_torch.core import RSPSpec, RSPStore, two_stage_partition_np
from repro_torch.data import BlockSource, PrefetchLoader, RSPLoader, make_higgs_like
from repro_torch.rsp.engine import BlockExecutor, StoreFetcher


@pytest.fixture()
def store(tmp_path):
    x, y = make_higgs_like(2048, num_features=4, seed=0)
    data = np.concatenate([x, y[:, None].astype(np.float32)], axis=1)
    spec = RSPSpec(num_records=2048, num_blocks=8, num_original_blocks=8, seed=3)
    blocks = two_stage_partition_np(data, spec)
    s = RSPStore(str(tmp_path / "rsp"))
    s.write_partition(blocks, spec)
    return s, blocks, spec


def _src(s, **kw):
    return BlockSource(store=s, device="cpu", **kw)


def _equal(got, want):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The reference's tests, on host tensors
# ---------------------------------------------------------------------------

def test_loader_batches_cover_epoch(store):
    s, blocks, _ = store
    loader = RSPLoader(_src(s), batch_size=128, seed=0)
    seen = [loader.next_batch() for _ in range(16)]  # 16*128 = 2048 = one epoch
    allb = torch.cat(seen).numpy()
    flat = blocks.reshape(-1, blocks.shape[-1])
    # batch records are exactly the corpus records (multiset equality)
    assert allb.shape == flat.shape
    a = np.sort(allb.view(np.uint8).reshape(allb.shape[0], -1), axis=0)
    b = np.sort(flat.view(np.uint8).reshape(flat.shape[0], -1), axis=0)
    np.testing.assert_array_equal(a, b)


def test_loader_resume_exact(store):
    s, _, _ = store
    ref = RSPLoader(_src(s), batch_size=64, seed=7)
    ref_batches = [ref.next_batch() for _ in range(10)]
    live = RSPLoader(_src(s), batch_size=64, seed=7)
    for _ in range(4):
        live.next_batch()
    state = live.state_dict()
    resumed = RSPLoader(_src(s), batch_size=64, seed=7)
    resumed.load_state_dict(state)
    for i in range(4, 10):
        _equal(resumed.next_batch(), ref_batches[i])


def test_loader_in_memory_source():
    blocks = np.arange(4 * 10 * 2, dtype=np.float32).reshape(4, 10, 2)
    loader = RSPLoader(BlockSource(blocks=blocks, device="cpu"), batch_size=5, seed=1)
    b = loader.next_batch()
    assert b.shape == (5, 2) and b.device.type == "cpu"


def test_prefetch_loader(store):
    s, _, _ = store
    inner_a = RSPLoader(_src(s), batch_size=50, seed=3)
    inner_b = RSPLoader(_src(s), batch_size=50, seed=3)
    pf = PrefetchLoader(inner_a, depth=2)
    try:
        got = [pf.next_batch() for _ in range(6)]
    finally:
        pf.close()
    for g, w in zip(got, [inner_b.next_batch() for _ in range(6)]):
        _equal(g, w)


def test_loader_transform(store):
    s, _, _ = store
    loader = RSPLoader(_src(s), batch_size=10, seed=0, transform=lambda b: b * 2.0)
    b1 = loader.next_batch()
    loader2 = RSPLoader(_src(s), batch_size=10, seed=0)
    _equal(b1, loader2.next_batch() * 2.0)


def test_loader_resume_across_epoch_boundary(store):
    # 2048 records, batch 192 -> the epoch boundary falls inside batch 11;
    # checkpoint right before it and verify exact-batch equivalence after.
    s, _, _ = store
    ref = RSPLoader(_src(s), batch_size=192, seed=11)
    ref_batches = [ref.next_batch() for _ in range(16)]
    live = RSPLoader(_src(s), batch_size=192, seed=11)
    for _ in range(10):
        live.next_batch()
    state = live.state_dict()
    assert state["pool"]  # open-pool entries ride along in the checkpoint
    resumed = RSPLoader(_src(s), batch_size=192, seed=11)
    resumed.load_state_dict(state)
    for i in range(10, 16):
        _equal(resumed.next_batch(), ref_batches[i])


def test_loader_resume_is_pool_bounded(store, monkeypatch):
    # Resume must reload only the open-pool blocks, not replay the history.
    s, _, _ = store
    live = RSPLoader(_src(s), batch_size=64, seed=3, prefetch=0)
    for _ in range(12):
        live.next_batch()
    state = live.state_dict()

    loads: list[int] = []
    orig = BlockSource.load

    def spying(self, block_id):
        loads.append(block_id)
        return orig(self, block_id)

    monkeypatch.setattr(BlockSource, "load", spying)
    resumed = RSPLoader(_src(s), batch_size=64, seed=3, prefetch=0)
    resumed.load_state_dict(state)
    assert sorted(loads) == sorted(e["block_id"] for e in state["pool"])


def test_loader_resume_self_contained_seed(store):
    # the checkpoint carries the permutation seed: a loader constructed with
    # a different seed still resumes the original stream exactly
    s, _, _ = store
    ref = RSPLoader(_src(s), batch_size=64, seed=7)
    ref_batches = [ref.next_batch() for _ in range(10)]
    live = RSPLoader(_src(s), batch_size=64, seed=7)
    for _ in range(4):
        live.next_batch()
    state = live.state_dict()
    resumed = RSPLoader(_src(s), batch_size=64, seed=0)  # wrong seed
    resumed.load_state_dict(state)
    for i in range(4, 10):
        _equal(resumed.next_batch(), ref_batches[i])


def test_loader_legacy_state_replays(store):
    # v1 checkpoints (sampler seed + consumed count, no pool) still resume
    s, _, _ = store
    ref = RSPLoader(_src(s), batch_size=64, seed=7)
    ref_batches = [ref.next_batch() for _ in range(8)]
    legacy = {"sampler": {"seed": 7, "epoch": 0, "cursor": 0}, "consumed_batches": 5}
    resumed = RSPLoader(_src(s), batch_size=64, seed=7)
    resumed.load_state_dict(legacy)
    for i in range(5, 8):
        _equal(resumed.next_batch(), ref_batches[i])


class _Flaky(BlockSource):
    def __init__(self, *a, fail_after: int, message: str, **kw):
        super().__init__(*a, **kw)
        self.calls, self.fail_after, self.message = 0, fail_after, message

    def load(self, block_id):
        self.calls += 1
        if self.calls > self.fail_after:
            raise RuntimeError(self.message)
        return super().load(block_id)


def test_loader_worker_exception_propagates(store):
    s, _, _ = store
    src = _Flaky(store=s, device="cpu", fail_after=2, message="store went away")
    loader = RSPLoader(src, batch_size=64, seed=0, prefetch=2)
    with pytest.raises(RuntimeError, match="store went away"):
        for _ in range(64):
            loader.next_batch()
    loader.close()


def test_prefetch_loader_exception_propagates(store):
    # a worker exception must surface, never leave next_batch() blocked
    s, _, _ = store
    src = _Flaky(store=s, device="cpu", fail_after=2, message="worker died")
    pf = PrefetchLoader(RSPLoader(src, batch_size=64, seed=0), depth=2)
    try:
        with pytest.raises(RuntimeError, match="worker died"):
            for _ in range(64):
                pf.next_batch()
    finally:
        pf.close()


def test_prefetch_loader_close_releases_inner_loader(store):
    s, _, _ = store
    inner = RSPLoader(_src(s), batch_size=50, seed=3, prefetch=2)
    pf = PrefetchLoader(inner, depth=2)
    pf.next_batch()
    pf.close()
    assert inner._executor._pool is None  # engine workers released
    assert not inner._pool  # no in-flight block fetches left behind


def test_loader_policy_stream_and_resume(store):
    s, _, _ = store
    ref = RSPLoader(_src(s), batch_size=64, seed=5, policy="weighted")
    ref_batches = [ref.next_batch() for _ in range(8)]
    assert all(b.shape == (64, 5) for b in ref_batches)

    live = RSPLoader(_src(s), batch_size=64, seed=5, policy="weighted")
    for _ in range(3):
        live.next_batch()
    state = live.state_dict()
    assert state["policy"]["kind"] == "weighted"
    resumed = RSPLoader(_src(s), batch_size=64, seed=5, policy="weighted")
    resumed.load_state_dict(state)
    for i in range(3, 8):
        _equal(resumed.next_batch(), ref_batches[i])

    mismatched = RSPLoader(_src(s), batch_size=64, seed=5)
    with pytest.raises(ValueError, match="policy"):
        mismatched.load_state_dict(state)

    # legacy (v1) states are uniform-only: no silent policy downgrade
    legacy = {"sampler": {"seed": 5, "epoch": 0, "cursor": 0}, "consumed_batches": 1}
    fresh = RSPLoader(_src(s), batch_size=64, seed=5, policy="weighted")
    with pytest.raises(ValueError, match="uniform-only"):
        fresh.load_state_dict(legacy)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_stream_batches_cover_records(store, prefetch):
    s, blocks, _ = store
    with BlockExecutor(StoreFetcher(s, device="cpu"), prefetch=prefetch) as ex:
        batches = list(ex.stream_batches(range(8), 96, drop_last=False))
    assert all(b.shape[0] == 96 for b in batches[:-1])
    _equal(torch.cat(batches), blocks.reshape(-1, 5))


def test_stream_batches_prepare_runs_per_block(store):
    s, blocks, _ = store
    with BlockExecutor(StoreFetcher(s, device="cpu"), prefetch=2) as ex:
        batches = list(ex.stream_batches(range(8), 64, prepare=lambda bid, b: b + bid,
                                         drop_last=False))
    want = np.concatenate([blocks[k] + k for k in range(8)])
    _equal(torch.cat(batches), want)
    with pytest.raises(ValueError, match="positive"):
        next(BlockExecutor(StoreFetcher(s, device="cpu")).stream_batches(range(8), 0))


def test_loader_uses_dataset_fetcher(tmp_path):
    # ds.loader() must train on what the dataset's fetcher serves, not on
    # raw store bytes behind a custom fetcher's back
    data = np.random.default_rng(0).normal(size=(256, 3)).astype(np.float32)
    ds = rsp.partition(data, blocks=4, seed=0, backend="np", device="cpu")
    ds.save(str(tmp_path / "c"))

    class ScalingFetcher:
        def __init__(self, store):
            self.inner = StoreFetcher(store, device="cpu")

        @property
        def num_blocks(self):
            return self.inner.num_blocks

        def fetch(self, k):
            return self.inner.fetch(k) * 10.0

    custom = rsp.RSPDataset(ds.spec, store=ds.store, fetcher=ScalingFetcher(ds.store),
                            device="cpu")
    batch = custom.loader(batch_size=32, seed=1).next_batch()
    plain = rsp.open(str(tmp_path / "c"), device="cpu").loader(batch_size=32, seed=1).next_batch()
    torch.testing.assert_close(batch, plain * 10.0, rtol=1e-6, atol=0)


def test_dataset_loader_covers_one_epoch():
    rng = np.random.default_rng(2)
    data = rng.normal(size=(1024, 4)).astype(np.float32)
    data[:, -1] = (rng.random(1024) < 0.5).astype(np.float32)
    ds = rsp.partition(data, blocks=8, seed=2, backend="np", num_classes=2, device="cpu")
    loader = ds.loader(batch_size=64, seed=1)
    allb = torch.cat([loader.next_batch() for _ in range(16)]).numpy()  # one epoch
    flat = ds.stacked().reshape(-1, data.shape[1]).numpy()
    a = np.sort(allb.view(np.uint8).reshape(allb.shape[0], -1), axis=0)
    b = np.sort(flat.view(np.uint8).reshape(flat.shape[0], -1), axis=0)
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Side by side with the reference over one store
# ---------------------------------------------------------------------------

def _both(s, **kw):
    return (RSPLoader(_src(s), **kw),
            ref_loader.RSPLoader(ref_loader.BlockSource(store=ref_rsp.open(s.root).store), **kw))


@pytest.mark.parametrize("batch,policy,prefetch", [
    (64, "uniform", 2), (192, "uniform", 0), (300, "weighted", 2), (100, "weighted", 1)])
def test_batches_equal_the_reference_bit_for_bit(store, batch, policy, prefetch):
    s, _, _ = store
    mine, ref = _both(s, batch_size=batch, seed=9, policy=policy, prefetch=prefetch)
    for _ in range(2 * 2048 // batch + 1):           # past an epoch boundary
        _equal(mine.next_batch(), ref.next_batch())
    assert mine.state_dict() == ref.state_dict()
    mine.close()
    ref.close()


@pytest.mark.parametrize("direction", ["reference -> port", "port -> reference"])
@pytest.mark.parametrize("version", [2, 1])
def test_states_resume_across_packages(store, direction, version):
    s, _, _ = store
    mine, ref = _both(s, batch_size=192, seed=4)
    saver, resumer = (ref, mine) if direction == "reference -> port" else (mine, ref)
    for _ in range(10):
        saver.next_batch()
    state = saver.state_dict()
    if version == 1:
        state = {"sampler": {"seed": 4, "epoch": 0, "cursor": 0}, "consumed_batches": 10}
    resumer.load_state_dict(state)
    for _ in range(6):
        _equal(*((resumer.next_batch(), saver.next_batch()) if resumer is mine
                 else (saver.next_batch(), resumer.next_batch())))


def test_stream_batches_equal_the_reference(store):
    s, _, _ = store
    order = [3, 1, 4, 1, 5, 7, 2, 6]

    def perm(bid, b):
        return b[np.random.default_rng(bid).permutation(b.shape[0])]

    with BlockExecutor(StoreFetcher(s, device="cpu"), prefetch=2) as ex, \
            RefExecutor(RefStoreFetcher(s), prefetch=2) as ref_ex:
        got = list(ex.stream_batches(order, 100, prepare=lambda bid, b: perm(bid, b),
                                     transform=lambda b: b * 2.0))
        want = list(ref_ex.stream_batches(order, 100, prepare=perm, transform=lambda b: b * 2.0))
    assert len(got) == len(want) == 2048 // 100
    for g, w in zip(got, want):
        _equal(g, w)


@pytest.mark.parametrize("stored", [False, True], ids=["memory", "store"])
def test_dataset_loader_and_deal_match_the_reference(store, tmp_path, stored):
    _, blocks, _ = store
    data = blocks.reshape(-1, 5)
    ref_ds = ref_rsp.partition(data, blocks=8, seed=1, backend="np", num_classes=2)
    ds = rsp.partition(data, blocks=8, seed=1, backend="np", num_classes=2, device="cpu")
    if stored:
        ref_ds.save(str(tmp_path / "c"))
        ref_ds, ds = ref_rsp.open(str(tmp_path / "c")), rsp.open(str(tmp_path / "c"), device="cpu")
    mine, ref = ds.loader(128, seed=3), ref_ds.loader(128, seed=3)
    for _ in range(20):
        _equal(mine.next_batch(), ref.next_batch())
    for hosts, epoch in ((3, 0), (4, 2)):
        got, want = ds.deal(hosts, seed=5, epoch=epoch), ref_ds.deal(hosts, seed=5, epoch=epoch)
        assert got.host_blocks == want.host_blocks
        assert got.redistribute([1]).host_blocks == want.redistribute([1]).host_blocks
