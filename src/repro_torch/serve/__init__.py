"""Serving: the batched LM engine and the RSP block ensemble."""

from repro_torch.serve.engine import EnsembleServer, ServeConfig, Server, ensemble_logprobs

__all__ = ["EnsembleServer", "ServeConfig", "Server", "ensemble_logprobs"]
