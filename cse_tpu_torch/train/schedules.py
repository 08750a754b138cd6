"""Learning-rate schedules of the trainer recipes.

Port of ``cse_tpu/train/schedules.py``. A schedule maps the 0-based count of
prior updates to a learning rate: update k (1-based) runs at f(k - 1), so the
first update of a warmup schedule has lr 0 (torch ``LambdaLR`` stepped after
``optimizer.step()``, as the reference trainers do).

* cosine_warmup: linear 0 -> 1 over ``warmup`` steps, then cosine 1 -> 0 over
  the remaining ``total - warmup`` steps;
* linear_warmup: linear 0 -> 1 over ``warmup`` steps, then constant 1;
* ReduceLROnPlateau(mode='max', factor=0.5, patience=5, threshold=1e-4):
  host-side, stepped on validation SI-SNR; its scale goes into the optimizer
  through :func:`cse_tpu_torch.train.optimizer.set_plateau_scale`.

The schedules compute in float32, as the JAX ones do under jit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def cosine_warmup_schedule(base_lr: float, total_steps: int, warmup_steps: int):
    def schedule(count: int) -> float:
        it = np.float32(count)
        warm = it / np.float32(max(warmup_steps, 1))
        prog = (it - np.float32(warmup_steps)) / np.float32(max(total_steps - warmup_steps, 1))
        cos = np.float32(0.5) * (np.float32(1.0) + np.cos(np.float32(math.pi) * prog, dtype=np.float32))
        return float(np.float32(base_lr) * (warm if it <= warmup_steps else cos))

    return schedule


def linear_warmup_schedule(base_lr: float, warmup_steps: int):
    def schedule(count: int) -> float:
        ratio = np.float32(count) / np.float32(max(warmup_steps, 1))
        return float(np.float32(base_lr) * min(ratio, np.float32(1.0)))

    return schedule


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch semantics, mode='max')."""

    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    best: float = -float("inf")
    num_bad: int = 0
    scale: float = 1.0

    def step(self, metric: float) -> float:
        # torch's relative threshold rule for mode='max': a > best * (1 + threshold)
        better = metric > self.best * (1.0 + self.threshold) if math.isfinite(self.best) else True
        if better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.scale *= self.factor
                self.num_bad = 0
        return self.scale

    def state_dict(self) -> dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: dict):
        for k, v in d.items():
            setattr(self, k, v)
