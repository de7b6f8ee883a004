"""Plan-compiled fused query passes: predicate filter + column projection
+ grouped moment/histogram sketch in one pass over a block, with the numpy
oracle (``ref.py``), the plain PyTorch version and the CUDA kernel
(``kernel.py``, source ``csrc/plan_sketch.cu``), and the plan-keyed
compile cache (``ops.py``)."""

from repro_torch.kernels.plan.kernel import (
    LAUNCHES,
    MAX_PREDICATES,
    PlanArrays,
    plan_sketch_cuda,
    plan_sketch_plain,
)
from repro_torch.kernels.plan.ops import (
    IMPLS,
    cache_clear,
    cache_info,
    compile_plan,
    plan_sketch,
)
from repro_torch.kernels.plan.plan import (
    Predicate,
    QueryPlan,
    as_predicates,
    parse_predicate,
)
from repro_torch.kernels.plan.ref import PlanResult, empty_sketch, plan_sketch_ref

__all__ = [
    "IMPLS",
    "LAUNCHES",
    "MAX_PREDICATES",
    "PlanArrays",
    "PlanResult",
    "Predicate",
    "QueryPlan",
    "as_predicates",
    "cache_clear",
    "cache_info",
    "compile_plan",
    "empty_sketch",
    "parse_predicate",
    "plan_sketch",
    "plan_sketch_cuda",
    "plan_sketch_plain",
    "plan_sketch_ref",
]
