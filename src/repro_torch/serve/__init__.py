"""Serving: concurrent multi-tenant approximate *query* serving over one
``RSPDataset`` (:mod:`repro_torch.serve.query_service`: admission control,
deadline-aware step scheduling, anytime responses; entry point
``ds.serve()``), and the batched LM engine with the RSP block ensemble
(:mod:`repro_torch.serve.engine`)."""

from repro_torch.serve.admission import (
    AdmissionController,
    AdmissionRejected,
    AdmissionSnapshot,
)
from repro_torch.serve.engine import EnsembleServer, ServeConfig, Server, ensemble_logprobs
from repro_torch.serve.query_service import (
    OUTCOMES,
    QueryService,
    QueryTicket,
    ServiceMetrics,
)
from repro_torch.serve.scheduler import StepScheduler

__all__ = [
    "OUTCOMES",
    "AdmissionController",
    "AdmissionRejected",
    "AdmissionSnapshot",
    "EnsembleServer",
    "QueryService",
    "QueryTicket",
    "ServeConfig",
    "Server",
    "ServiceMetrics",
    "StepScheduler",
    "ensemble_logprobs",
]
