"""repro_torch.core -- the paper's contribution: the Random Sample Partition
model (low-level layer; new code starts at the ``repro_torch.rsp`` facade).

  types        RSPSpec, SamplerState, BlockDescriptor
  partition    two_stage_partition_np (Algorithm 1), is_partition,
               empirical_cdf (Defs. 2/3)
  sampling     BlockSampler, deal_blocks, HostAssignment (Definition 4),
               the uniform / weighted / stratified / query_aware policies
  estimation   MomentStats, combine_moments, block_histogram,
               quantile_from_histogram (Sec. 8)
  storage      RSPStore, PartitionWriter (byte-compatible with ``repro``)
"""

from repro_torch.core.types import BlockDescriptor, RSPSpec, SamplerState
from repro_torch.core.partition import (
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
    MomentStats,
    block_histogram,
    combine_moments,
    quantile_from_histogram,
)
from repro_torch.core.registry import PartitionWriter, RSPStore

__all__ = [k for k in dir() if not k.startswith("_")]
