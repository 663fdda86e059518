"""The paper's own evaluation scale (port of
``repro.configs.timefloats_mlp``): a small edge MLP classifier trained
entirely with TimeFloats arithmetic on a 64x128-crossbar-sized problem.

The paper evaluates TimeFloats on 64-element scalar products in a 64x128
crossbar and (Fig 7) on a small classifier under process variability.
This config is that train-in-memory "model": 64 -> 128 -> 128 -> 10 in
exact mode, batch 128.
"""
import dataclasses
from typing import Tuple

from repro_torch.core.timefloats import TFConfig


@dataclasses.dataclass(frozen=True)
class EdgeMLPConfig:
    name: str = "timefloats-mlp"
    in_dim: int = 64           # one crossbar worth of inputs
    hidden: Tuple[int, ...] = (128, 128)   # crossbar column count
    n_classes: int = 10
    tf: TFConfig = TFConfig(mode="exact")  # paper-faithful arithmetic
    lr: float = 0.05
    steps: int = 300
    batch: int = 128
    insitu_updates: bool = True  # weights live in FP8 (no master copy)


CONFIG = EdgeMLPConfig()
