"""repro_torch.core -- the paper's contribution: the Random Sample Partition
model (low-level layer; new code starts at the ``repro_torch.rsp`` facade).

  types        RSPSpec, SamplerState, BlockDescriptor
  partition    two_stage_partition_np (Algorithm 1),
               distributed_rsp_partition (Algorithm 1 as one collective),
               is_partition, empirical_cdf (Defs. 2/3)
  sampling     BlockSampler, deal_blocks, HostAssignment (Definition 4),
               the uniform / weighted / stratified / query_aware policies
  estimation   BlockLevelEstimator, MomentStats, block_moments,
               combine_moments, batched_block_moments, block_histogram,
               quantile_from_histogram, streaming_estimate (Sec. 8)
  ensemble     BaseLearner, make_logreg, make_mlp, Ensemble,
               EnsembleHistory, train_base_models_vmapped,
               asymptotic_ensemble_learn, ensemble_vs_single_model,
               params_from_numpy (Sec. 9, Algorithm 2)
  similarity   mmd2_rbf, mmd_block_vs_data, median_heuristic_gamma,
               hotelling_t2, ks_statistic, label_distribution,
               max_label_divergence (Sec. 7)
  storage      RSPStore, PartitionWriter (byte-compatible with ``repro``)
  monitoring   DriftMonitor, DriftReport (Sec. 10)
"""

from repro_torch.core.types import BlockDescriptor, RSPSpec, SamplerState
from repro_torch.core.partition import (
    distributed_rsp_partition,
    empirical_cdf,
    is_partition,
    two_stage_partition_np,
)
from repro_torch.core.sampler import (
    POLICIES,
    BlockSampler,
    HostAssignment,
    QueryAwarePolicy,
    SamplingPolicy,
    StratifiedPolicy,
    UniformPolicy,
    WeightedPolicy,
    deal_blocks,
    make_policy,
    sketch_dispersion,
)
from repro_torch.core.estimators import (
    BlockLevelEstimator,
    MomentStats,
    batched_block_moments,
    block_histogram,
    block_moments,
    combine_moments,
    quantile_from_histogram,
    streaming_estimate,
)
from repro_torch.core.ensemble import (
    BaseLearner,
    Ensemble,
    EnsembleHistory,
    asymptotic_ensemble_learn,
    ensemble_vs_single_model,
    make_logreg,
    make_mlp,
    params_from_numpy,
    train_base_models_vmapped,
)
from repro_torch.core.similarity import (
    hotelling_t2,
    ks_statistic,
    label_distribution,
    max_label_divergence,
    median_heuristic_gamma,
    mmd2_rbf,
    mmd_block_vs_data,
)
from repro_torch.core.registry import PartitionWriter, RSPStore
from repro_torch.core.monitor import DriftMonitor, DriftReport

__all__ = [k for k in dir() if not k.startswith("_")]
