"""The trainer's optimizer: AdamW-amsgrad as optax 0.2.6 computes it.

Port of ``cse_tpu/train/optimizer.py``, written by hand on plain tensors.
``torch.optim.AdamW(amsgrad=True)`` is a different algorithm (it takes the
maximum of the raw second moment, not of the bias-corrected one), so the
chain is spelled out here, in optax's order and arithmetic:

1. ``clip_by_global_norm(clip_norm)``: g * clip_norm / ||g|| when ||g|| >= clip_norm;
2. ``scale_by_amsgrad``: mu, nu moments; mu_hat, nu_hat bias-corrected with
   count + 1; nu_max = max(nu_max, nu_hat); u = mu_hat / (sqrt(nu_max) + eps);
3. ``add_decayed_weights``: u += weight_decay * p;
4. ``scale_by_learning_rate``: u *= -lr(count), with its own count;
5. ``scale_by_plateau``: u *= the plateau scale (:func:`set_plateau_scale`);

all inside ``apply_if_finite``: when any incoming gradient is non-finite the
update is zero and no inner state or count advances; and, for
``update_frequency > 1``, inside ``MultiSteps``: the running (Welford) mean
of k gradients goes through the chain on the k-th call, the other calls
emit zero updates.

Usage: ``opt = build_optimizer(schedule)``; ``state = opt.init(params)``;
``opt.step(params, grads, state)`` updates ``params`` and ``state`` in place.
The moments are fp32 tensors on the parameters' device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from cse_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class OptState:
    count: int  # scale_by_amsgrad's update count
    lr_count: int  # scale_by_learning_rate's count
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    nu_max: list[torch.Tensor]
    plateau_scale: float = 1.0
    # apply_if_finite
    notfinite_count: int = 0
    total_notfinite: int = 0
    last_finite: bool = True
    # MultiSteps (update_frequency > 1)
    mini_step: int = 0
    gradient_step: int = 0
    acc_grads: list[torch.Tensor] | None = None


def set_plateau_scale(state: OptState, scale: float) -> OptState:
    """Set the learning-rate multiplier that ReduceLROnPlateau decided."""
    state.plateau_scale = float(np.float32(scale))
    return state


def get_plateau_scale(state: OptState) -> float:
    return state.plateau_scale


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in fp32 (a 0-d tensor)."""
    sq = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt(torch.sum(torch.stack(sq) ** 2))


def _f32(v) -> float:
    return float(np.float32(v))


class AdamWAmsgrad:
    """The chain of the module docstring; see :func:`build_optimizer`."""

    def __init__(self, schedule: Callable[[int], float] | float, weight_decay: float = 1e-6,
                 clip_norm: float = 5.0, update_frequency: int = 1, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule = schedule if callable(schedule) else (lambda count, lr=schedule: lr)
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.update_frequency = update_frequency
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
        return OptState(count=0, lr_count=0, mu=zeros(), nu=zeros(), nu_max=zeros(),
                        acc_grads=zeros() if self.update_frequency > 1 else None)

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor | None],
             state: OptState) -> bool:
        """One optimizer call: updates ``params`` (in place) and ``state``.

        ``grads[i]`` of None counts as zeros. Returns True when the parameters
        moved (False: a MultiSteps accumulation call or a skipped non-finite
        step)."""
        grads = [torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                 for p, g in zip(params, grads)]
        if self.update_frequency <= 1:
            return self._if_finite(params, grads, state)
        k, n = self.update_frequency, state.mini_step
        # Welford running mean, as optax.MultiSteps(use_grad_mean=True)
        for a, g in zip(state.acc_grads, grads):
            a.add_((g - a) / (n + 1))
        emit = n == k - 1
        state.mini_step = (n + 1) % k
        if not emit:
            return False
        moved = self._if_finite(params, state.acc_grads, state)
        state.gradient_step += 1
        torch._foreach_mul_(state.acc_grads, 0.0)  # (1 - emit) * acc, NaN stays NaN as in optax
        return moved

    def _if_finite(self, params, grads, state: OptState) -> bool:
        # max |g| of each tensor: NaN or inf exactly where an element is, and never overflows
        finite = torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all()
        with span("train.optimizer.read_finite"):
            finite = bool(finite)
        state.last_finite = finite
        if not finite:
            state.notfinite_count += 1
            state.total_notfinite += 1
            return False
        state.notfinite_count = 0
        self._chain(params, grads, state)
        return True

    def _chain(self, params, grads, state: OptState):
        b1, b2, eps = self.b1, self.b2, self.eps
        g_norm = global_norm(grads)
        below = g_norm < self.clip_norm
        with span("train.optimizer.read_clip"):
            below = bool(below)
        if not below:
            grads = [(g / g_norm) * self.clip_norm for g in grads]
        # scale_by_amsgrad
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_add_(state.nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        state.count += 1
        c = np.float32(state.count)
        bc1 = _f32(np.float32(1) - np.power(np.float32(b1), c, dtype=np.float32))
        bc2 = _f32(np.float32(1) - np.power(np.float32(b2), c, dtype=np.float32))
        nu_hat = torch._foreach_div(state.nu, bc2)
        torch._foreach_maximum_(state.nu_max, nu_hat)
        u = torch._foreach_div(state.mu, bc1)
        denom = torch._foreach_sqrt(state.nu_max)
        torch._foreach_add_(denom, eps)
        torch._foreach_div_(u, denom)
        # add_decayed_weights
        torch._foreach_add_(u, torch._foreach_mul([p.float() for p in params], self.weight_decay))
        # scale_by_learning_rate (its own count), then scale_by_plateau
        lr = _f32(-np.float32(self.schedule(state.lr_count)))
        state.lr_count += 1
        torch._foreach_mul_(u, lr)
        torch._foreach_mul_(u, state.plateau_scale)
        if all(p.dtype == torch.float32 for p in params):
            torch._foreach_add_(params, u)
        else:
            for p, du in zip(params, u):
                p.copy_((p.float() + du).to(p.dtype))


def build_optimizer(schedule: Callable[[int], float] | float, weight_decay: float = 1e-6,
                    clip_norm: float = 5.0, update_frequency: int = 1, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8) -> AdamWAmsgrad:
    """The reference trainers' optimizer (see the module docstring)."""
    return AdamWAmsgrad(schedule, weight_decay, clip_norm, update_frequency, b1, b2, eps)
