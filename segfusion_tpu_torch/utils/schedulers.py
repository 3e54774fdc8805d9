"""Learning-rate schedules as plain functions of the optimizer step.

Port of ``segfusion_tpu/utils/schedulers.py`` (and the optax schedules it
builds on): constant, polynomial, multi-step, step, cosine annealing and
exponential, each optionally wrapped with a linear or constant warmup.
The step counts optimizer updates (one per accumulated chunk), starting
at 0 for the first update, as optax's ``count`` does. Rates are computed
in float32, as optax computes them: near a schedule's horizon its
``1 - step / max_iter`` or ``1 + cos`` cancels, and the float32 rounding
that amplifies is part of the rate the JAX trainer applies.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

__all__ = ["get_schedule"]

Schedule = Callable[[int], float]


f32 = np.float32


def constant_lr(base_lr: float) -> Schedule:
    return lambda step: float(f32(base_lr))


def polynomial_lr(base_lr: float, max_iter: int,
                  gamma: float = 0.9) -> Schedule:
    """base * (1 - min(step, max_iter) / max_iter) ** gamma."""
    return lambda step: float(f32(base_lr) * (
        f32(1.0) - f32(min(step, max_iter)) / f32(max_iter)) ** f32(gamma))


def multi_step_lr(base_lr: float, milestones, gamma: float) -> Schedule:
    """base * gamma ** (number of milestones <= step)."""
    ms = sorted(set(int(m) for m in milestones))

    def sched(step):
        v = f32(base_lr)
        for m in ms:
            if step >= m:
                v = f32(gamma) * v
        return float(v)
    return sched


def exponential_lr(base_lr: float, every: int, gamma: float,
                   staircase: bool = False) -> Schedule:
    """base * gamma ** (step / every), the exponent floored with
    ``staircase``; base at step 0."""
    def sched(step):
        p = f32(step) / f32(every)
        if staircase:
            p = np.floor(p)
        return float(f32(base_lr) if step <= 0
                     else f32(base_lr) * f32(gamma) ** p)
    return sched


def cosine_lr(base_lr: float, t_max: int, eta_min: float) -> Schedule:
    """Cosine from base to eta_min over t_max steps, then eta_min."""
    alpha = f32(eta_min / max(base_lr, 1e-30))

    def sched(step):
        c = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * f32(min(step, t_max))
                                          / f32(t_max)))
        return float(f32(base_lr) * ((f32(1.0) - alpha) * c + alpha))
    return sched


def warmup_wrap(schedule: Schedule, warmup_iters: int = 100,
                mode: str = "linear", gamma: float = 0.2) -> Schedule:
    """Scale the first ``warmup_iters`` steps: linearly from ``gamma`` to
    1 (linear) or by ``gamma`` (constant)."""
    if mode not in ("linear", "constant"):
        raise KeyError(f"WarmUp type {mode} not implemented")

    def sched(step):
        cold = f32(schedule(step))
        if step >= warmup_iters:
            return float(cold)
        if mode == "constant":
            return float(f32(gamma) * cold)
        alpha = np.clip(f32(step) / f32(warmup_iters), f32(0.0), f32(1.0))
        return float((f32(gamma) * (f32(1.0) - alpha) + alpha) * cold)
    return sched


def get_schedule(base_lr: float, scheduler_cfg: Any) -> Schedule:
    """TRAINING.scheduler config -> schedule (the JAX package's factory)."""
    if scheduler_cfg is None:
        return constant_lr(base_lr)
    cfg = dict(scheduler_cfg)
    name = cfg.pop("name", "constant_lr")
    warmup = None
    if "warmup_iters" in cfg:
        warmup = {"warmup_iters": int(cfg.pop("warmup_iters", 100)),
                  "mode": cfg.pop("warmup_mode", "linear"),
                  "gamma": float(cfg.pop("warmup_factor", 0.2))}

    if name == "constant_lr":
        sched = constant_lr(base_lr)
    elif name == "poly_lr":
        sched = polynomial_lr(base_lr, int(cfg.get("max_iter", 100000)),
                              float(cfg.get("gamma", 0.9)))
    elif name == "multi_step":
        sched = multi_step_lr(base_lr, cfg.get("milestones", [30, 80]),
                              float(cfg.get("gamma", 0.1)))
    elif name == "step":
        sched = exponential_lr(base_lr, int(cfg.get("step_size", 30)),
                               float(cfg.get("gamma", 0.1)), staircase=True)
    elif name == "cosine_annealing":
        sched = cosine_lr(base_lr, int(cfg.get("T_max", 50000)),
                          float(cfg.get("eta_min", 0.0)))
    elif name == "exp_lr":
        sched = exponential_lr(base_lr, 1, float(cfg.get("gamma", 0.99)))
    else:
        raise NotImplementedError(f"Scheduler {name} not implemented")
    return warmup_wrap(sched, **warmup) if warmup else sched
