"""LR-multiplier schedules (counterpart of hi3d_tpu/training/schedules.py).

Each scheduler is callable on an int step and returns the multiplier of the
base learning rate as a Python float, so it drives
`torch.optim.lr_scheduler.LambdaLR` directly
(`LambdaLR(optimizer, lr_lambda=scheduler)`) and the optimizer and scheduler
state hold plain floats, which `torch.load(weights_only=True)` accepts.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence


class LambdaWarmUpCosineScheduler:
    """Single cycle: linear warm-up, then cosine decay to lr_min."""

    def __init__(self, warm_up_steps: int, lr_min: float, lr_max: float, lr_start: float,
                 max_decay_steps: int, verbosity_interval: int = 0):
        self.warm_up_steps = int(warm_up_steps)
        self.lr_min = float(lr_min)
        self.lr_max = float(lr_max)
        self.lr_start = float(lr_start)
        self.max_decay_steps = int(max_decay_steps)

    def schedule(self, n: int) -> float:
        if n < self.warm_up_steps:
            return (self.lr_max - self.lr_start) / self.warm_up_steps * n + self.lr_start
        t = min((n - self.warm_up_steps) / (self.max_decay_steps - self.warm_up_steps), 1.0)
        return self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (1 + math.cos(t * math.pi))

    def __call__(self, n: int) -> float:
        return self.schedule(n)


class _MultiCycle:
    """Cycle bookkeeping shared by the multi-cycle schedulers."""

    def __init__(self, warm_up_steps: Sequence[int], f_min: Sequence[float],
                 f_max: Sequence[float], f_start: Sequence[float],
                 cycle_lengths: Sequence[int], verbosity_interval: int = 0):
        if len({len(warm_up_steps), len(f_min), len(f_max), len(f_start),
                len(cycle_lengths)}) != 1:
            raise ValueError("all schedule lists must have equal length")
        self.warm_up_steps = [int(v) for v in warm_up_steps]
        self.f_min = [float(v) for v in f_min]
        self.f_max = [float(v) for v in f_max]
        self.f_start = [float(v) for v in f_start]
        self.cycle_lengths = [int(v) for v in cycle_lengths]
        self.cum_cycles = [0, *itertools.accumulate(self.cycle_lengths)]

    def find_in_interval(self, n: int) -> int:
        for interval, cl in enumerate(self.cum_cycles[1:]):
            if n <= cl:
                return interval
        return len(self.cycle_lengths) - 1

    def _warm(self, cycle: int, n: int) -> float:
        return ((self.f_max[cycle] - self.f_start[cycle]) / self.warm_up_steps[cycle] * n
                + self.f_start[cycle])

    def __call__(self, n: int) -> float:
        return self.schedule(n)


class LambdaWarmUpCosineScheduler2(_MultiCycle):
    """Per cycle: linear warm-up, then cosine decay to f_min."""

    def schedule(self, n: int) -> float:
        cycle = self.find_in_interval(n)
        n = n - self.cum_cycles[cycle]
        if n < self.warm_up_steps[cycle]:
            return self._warm(cycle, n)
        t = min((n - self.warm_up_steps[cycle])
                / (self.cycle_lengths[cycle] - self.warm_up_steps[cycle]), 1.0)
        return self.f_min[cycle] + 0.5 * (self.f_max[cycle] - self.f_min[cycle]) * (
            1 + math.cos(t * math.pi))


class LambdaLinearScheduler(_MultiCycle):
    """Per cycle: linear warm-up, then linear decay to f_min over the cycle."""

    def schedule(self, n: int) -> float:
        cycle = self.find_in_interval(n)
        n = n - self.cum_cycles[cycle]
        if n < self.warm_up_steps[cycle]:
            return self._warm(cycle, n)
        return self.f_min[cycle] + (self.f_max[cycle] - self.f_min[cycle]) * (
            self.cycle_lengths[cycle] - n) / self.cycle_lengths[cycle]
