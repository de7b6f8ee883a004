"""repro_torch.rsp -- the RSP pipeline facade on PyTorch and CUDA.

One import surface for the paper's workflow::

    from repro_torch import rsp

    ds = rsp.partition(data, blocks=100, seed=1, num_classes=2)  # device="cuda"
    ds.save("/data/corpus.rsp")
    ds = rsp.open("/data/corpus.rsp")                  # lazy re-open, on the card
    ids = ds.sample(5, seed=7)                         # block-level sample (Def. 4)
    stats = ds.moments(g=5)                            # Sec. 8, from block sketches
    res = ds.query(["mean", "p95"], target_rel_err=0.01, use_sketches=False)

``partition`` dispatches through a backend registry (the bit-exact numpy
path, and the ``cuda`` backend on the ``rsp_shuffle`` kernel); progressive
queries sketch each block with the ``block_sketch`` and ``plan`` CUDA
kernels.  Every entry point defaults to ``device="cuda"`` and raises when no
card is present; pass ``device="cpu"`` to run on the host.
"""

from repro_torch.core.estimators import MomentStats
from repro_torch.core.sampler import (
    POLICIES,
    BlockSampler,
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

__all__ = [k for k in dir() if not k.startswith("_")]
