"""Serving: the dense fused continuous-batching engine."""
from repro_torch.serve.engine import Engine, EngineState  # noqa: F401
from repro_torch.serve.request import Finished, Request  # noqa: F401
