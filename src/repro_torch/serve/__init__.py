"""Serving: the fused continuous-batching engine, dense or paged, and its
host-side page pool and radix prefix cache."""
from repro_torch.serve.engine import Engine, EngineState  # noqa: F401
from repro_torch.serve.kvpool import TRASH_PAGE, PagePool  # noqa: F401
from repro_torch.serve.radix import RadixCache  # noqa: F401
from repro_torch.serve.request import Finished, Request  # noqa: F401
