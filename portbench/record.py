"""What one run measured: the data every metric's reader reads."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from .arith.trace import Trace


@dataclasses.dataclass
class Record:
    cell: dict
    config: dict
    mix: dict
    setup_s: float  # process start to the window's first step
    window_s: float  # the measured window, to the end of its last step
    step_s: List[float]  # host clock of each window step, ending at its loss read
    tokens_per_step: int
    flops_per_step: float  # model flops (arith.flops.train_model_flops)
    peak_bytes: int  # max_memory_allocated over the window
    attempted: int
    failed: int
    correct: bool
    checks: Dict[str, dict]
    trace: Optional[Trace] = None  # the traced steps after the window
    traced_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    device: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def steps(self) -> int:
        return len(self.step_s)

    def per_traced_step(self, seconds: float) -> float:
        return seconds / self.trace.n_steps()
