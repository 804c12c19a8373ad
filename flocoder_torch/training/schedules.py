"""Learning-rate and batch-size schedules, PyTorch port of
``flocoder_tpu/training/schedules.py``.

``cosine_warm_restarts_decay`` is torch's ``CosineAnnealingWarmRestarts``
stepped per epoch, whose base learning rate is multiplied by ``decay`` at
each warm restart, as a closed form ``schedule(step) -> lr`` of the
optimizer step. The port evaluates it on the host (the step count is a
host integer, so setting the optimizer's learning rate never waits on the
card): the cycle index and the cycle's start and length in exact integer
arithmetic, the cosine in float32 as the JAX package does. XLA's fused and
unfused evaluations of the JAX schedule themselves differ in the last bit,
so the two packages agree to one float32 ulp, not bitwise.

``batch_size_schedule`` is the host-side ``bs(epoch) -> int`` with StepBS /
MultiStepBS semantics; it is plain integer arithmetic and matches exactly.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["cosine_warm_restarts_decay", "batch_size_schedule"]


def batch_size_schedule(base_bs: int, gamma: float = 2.0,
                        step_every: int = 0, milestones=(),
                        max_bs: int | None = None, multiple_of: int = 1):
    """Returns ``bs(epoch) -> int`` (epoch is 1-based). ``step_every > 0``
    multiplies by ``gamma`` every ``step_every`` epochs; ``milestones``
    multiply by ``gamma`` at each listed epoch. Sizes are quantised down to
    a multiple of ``multiple_of`` and clamped to ``[multiple_of, max_bs]``;
    with neither knob the schedule is constant ``base_bs``."""
    if step_every and milestones:
        raise ValueError("set bs_step_every or bs_milestones, not both")
    if gamma <= 0:
        raise ValueError("bs_gamma must be > 0")
    milestones = sorted(int(m) for m in milestones)
    cap = int(max_bs) if max_bs else None

    def bs(epoch: int) -> int:
        if step_every:
            n = max(int(epoch) - 1, 0) // int(step_every)
        else:
            n = sum(1 for m in milestones if int(epoch) >= m)
        value = int(base_bs * (float(gamma) ** n))
        if cap is not None:
            value = min(value, cap)
        value = (value // multiple_of) * multiple_of
        return max(value, multiple_of)

    return bs


def _cycle(epoch: float, T_0: int, T_mult: int) -> tuple:
    """(n, start, length) of the warm-restart cycle that holds ``epoch``:
    cycle n spans T_0·T_mult**n epochs from T_0·(T_mult**n − 1)/(T_mult − 1)."""
    if T_mult == 1:
        n = int(math.floor(epoch / T_0))
        return n, n * T_0, T_0
    n, start, length = 0, 0, T_0
    while start + length <= epoch:
        n, start, length = n + 1, start + length, length * T_mult
    return n, start, length


def cosine_warm_restarts_decay(base_lr: float, T_0: int = 50, T_mult: int = 2,
                               decay: float = 0.6, eta_min: float = 0.0,
                               steps_per_epoch: int = 1):
    """Returns ``schedule(count) -> float``, ``count`` the optimizer step:
    ``lr = eta_min + (base_lr·decay**n − eta_min)·(1 + cos(π·T_cur/T_i))/2``
    within cycle n."""
    if T_mult < 1:
        raise ValueError("T_mult must be >= 1")
    f32 = np.float32

    def schedule(count) -> float:
        epoch = f32(int(count)) / f32(steps_per_epoch)
        n, start, length = _cycle(float(epoch), T_0, T_mult)
        t_cur = epoch - f32(start)
        lr_max = f32(base_lr) * f32(decay) ** f32(n)
        cos = np.cos(f32(math.pi) * t_cur / f32(length))
        return float(f32(eta_min) + (lr_max - f32(eta_min)) * (f32(1) + cos) / f32(2))

    return schedule
