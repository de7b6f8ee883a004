"""repro_torch.rsp -- the RSP pipeline facade on PyTorch and CUDA.

One import surface for the paper's workflow::

    from repro_torch import rsp

    ds = rsp.partition(data, blocks=100, seed=1, num_classes=2)  # device="cuda"
    ds.save("/data/corpus.rsp")
    ds = rsp.from_source("/data/corpus.npy", blocks=100, out="/data/c.rsp")
    ds = rsp.open("/data/corpus.rsp")                  # lazy re-open, on the card
    ids = ds.sample(5, seed=7)                         # block-level sample (Def. 4)
    stats = ds.moments(g=5)                            # Sec. 8, from block sketches
    est = ds.estimator(g=20)                           # Sec. 8, from block reads
    res = ds.query(["mean", "p95"], target_rel_err=0.01, use_sketches=False)
    with ds.serve(capacity=64, workers=8) as svc:      # concurrent tenants
        res = svc.result(svc.submit("p95", deadline_ms=500))
    ens, hist = ds.ensemble(rsp.make_logreg(28, 2), eval_x=xe, eval_y=ye, g=5)
    mmd = ds.similarity(3, metric="mmd")               # Sec. 7 diagnostics
    loader = ds.loader(8192, seed=0)                   # training batches

``partition`` dispatches through a backend registry (the bit-exact numpy
path, the out-of-core ``np_stream`` scatter for corpora on disk and ``out=``
writes, and the ``cuda`` backend on the ``rsp_shuffle`` kernel);
progressive queries, served queries and ``estimator`` sketch each block with
the ``block_sketch`` and ``plan`` CUDA kernels; ``ensemble`` trains its base
models, ``similarity`` scores a block and ``loader`` builds its batches on
the dataset's device.  Every entry point defaults to ``device="cuda"`` and raises when no
card is present; pass ``device="cpu"`` to run on the host.
"""

from repro_torch.core.ensemble import (
    BaseLearner,
    Ensemble,
    EnsembleHistory,
    make_logreg,
    make_mlp,
)
from repro_torch.core.estimators import BlockLevelEstimator, MomentStats
from repro_torch.core.monitor import DriftMonitor, DriftReport
from repro_torch.core.sampler import (
    POLICIES,
    BlockSampler,
    HostAssignment,
    QueryAwarePolicy,
    SamplingPolicy,
    StratifiedPolicy,
    UniformPolicy,
    WeightedPolicy,
    make_policy,
    sketch_dispersion,
)
from repro_torch.core.types import RSPSpec
from repro_torch.rsp.engine import (
    BlockExecutor,
    BlockFetcher,
    CallerStats,
    ExecutorStats,
    MemoryFetcher,
    MmapFetcher,
    ScopedFetcher,
    StoreFetcher,
    as_fetcher,
)
from repro_torch.kernels.plan import Predicate, QueryPlan
from repro_torch.rsp.query import (
    Aggregate,
    AggregateResult,
    Query,
    QueryExecutor,
    QueryResult,
    as_query,
    parse_aggregate,
)
from repro_torch.rsp.backends import (
    AUTO,
    PartitionBackend,
    PartitionRequest,
    available_backends,
    backend_eligibility,
    get_backend,
    register_backend,
    run_partition,
    select_backend,
)
from repro_torch.rsp.dataset import RSPDataset
from repro_torch.rsp.ingest import (
    ArrayChunkSource,
    ChunkSource,
    DirectoryChunkSource,
    IterChunkSource,
    NpyChunkSource,
    as_chunk_source,
    stream_partition,
)
from repro_torch.rsp.sketch import (
    SKETCH_KINDS,
    SKETCH_SCHEMA_VERSION,
    DistinctSketch,
    HistogramSketch,
    KLLSketch,
    LabelsSketch,
    MomentsSketch,
    Sketch,
    SketchSuite,
    kll_rank_error_bound,
    load_summaries,
    merge_suites,
    register_sketch,
    sketch_from_dict,
)
from repro_torch.rsp.summaries import (
    BlockSummary,
    combine_summaries,
    max_divergence_from_summaries,
    summarize_block,
    summarize_blocks,
)

partition = RSPDataset.partition
open = RSPDataset.open  # noqa: A001 -- facade verb, mirrors gzip.open
from_arrays = RSPDataset.from_arrays
from_source = RSPDataset.from_source

__all__ = [k for k in dir() if not k.startswith("_")]
