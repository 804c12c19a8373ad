"""ODE sampling for latent flow matching, PyTorch port of
``flocoder_tpu/sampling.py``.

The JAX package scans one jitted step over a precomputed warped time grid;
here the scan is a Python loop over the same grid (held as Python floats, so
the loop never waits on the device). Classifier-free guidance evaluates the
cond and uncond branches in one batched forward. Randomness comes from an
explicit ``torch.Generator``; tests pass ``source`` to compare with JAX.

Ported: Euler, RK4, Heun and midpoint with ``source=`` and
``init_latents``/``init_strength``. RK45, SDE, AB4 and MeanFlow are not
ported yet and raise NotImplementedError (ROADMAP.md). All arrays NHWC.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["warp_time", "euler_step", "rk4_step", "heun_step",
           "midpoint_step", "cfg_velocity", "generate_latents"]

_NOT_PORTED = ("rk45", "sde", "ab4", "meanflow")


def warp_time(t, dt=None, s: float = 0.5):
    """Parametric time warp ``tw = 4(1-s)t^3 + 6(s-1)t^2 + (3-2s)t``; s=1
    linear, s<1 slower middle, s>1 slower ends. With ``dt`` also returns the
    warped step via the analytic derivative."""
    if s < 0 or s > 1.5:
        raise ValueError(f"s={s} is out of bounds [0, 1.5].")
    t = torch.as_tensor(t)
    tw = 4 * (1 - s) * t**3 + 6 * (s - 1) * t**2 + (3 - 2 * s) * t
    if dt is not None:
        deriv = 12 * (1 - s) * t**2 + 12 * (s - 1) * t + (3 - 2 * s)
        return tw, dt * deriv
    return tw


def euler_step(f: Callable, y, t, dt):
    return y + dt * f(y, t)


def rk4_step(f: Callable, y, t, dt):
    k1 = f(y, t)
    k2 = f(y + dt * k1 / 2, t + dt / 2)
    k3 = f(y + dt * k2 / 2, t + dt / 2)
    k4 = f(y + dt * k3, t + dt)
    return y + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)


def heun_step(f: Callable, y, t, dt):
    k1 = f(y, t)
    k2 = f(y + dt * k1, t + dt)
    return y + (dt / 2) * (k1 + k2)


def midpoint_step(f: Callable, y, t, dt):
    k1 = f(y, t)
    return y + dt * f(y + (dt / 2) * k1, t + dt / 2)


_STEPS = {"euler": (euler_step, 1), "rk4": (rk4_step, 4),
          "heun": (heun_step, 2), "midpoint": (midpoint_step, 2)}


def cfg_velocity(apply_fn: Callable, cond: Optional[dict], cfg_strength: float,
                 t_scale: float = 999.0) -> Callable:
    """Velocity ``f(x, t) -> v`` with classifier-free guidance.
    ``apply_fn(x, t_vec, cond)`` is the model forward. With a class
    condition and a nonzero strength, cond and uncond (class id −1) run as
    ONE forward on the doubled batch, mixed as ``v_u + w·(v_c − v_u)``."""
    has_class = cond is not None and cond.get("class_cond") is not None
    use_cfg = has_class and cfg_strength is not None and cfg_strength != 0

    if not use_cfg:
        def f(x, t):
            t_vec = torch.full((x.shape[0],), float(t), dtype=x.dtype,
                               device=x.device) * t_scale
            return apply_fn(x, t_vec, cond)
        return f

    def f(x, t):
        b = x.shape[0]
        t_vec = torch.full((2 * b,), float(t), dtype=x.dtype,
                           device=x.device) * t_scale
        cond2 = dict(cond)
        cc = cond["class_cond"]
        cond2["class_cond"] = torch.cat([cc, torch.full_like(cc, -1)])
        if cond.get("time_horizon") is not None:
            cond2["time_horizon"] = torch.cat([cond["time_horizon"]] * 2)
        v2 = apply_fn(torch.cat([x, x]), t_vec, cond2)
        v_c, v_u = v2[:b], v2[b:]
        return v_u + cfg_strength * (v_c - v_u)

    return f


def _time_grid(n_steps: int, init_strength: float, warp_s: Optional[float],
               dtype=torch.float32) -> torch.Tensor:
    """Warped integration grid t ∈ [init_strength, 1]. As in the JAX
    package, the warp is applied after the grid starts at init_strength."""
    if init_strength > 0:
        n_steps = max(1, int(n_steps * (1.0 - init_strength)))
    ts = torch.linspace(init_strength, 1.0, n_steps, dtype=dtype)
    if warp_s is not None:
        ts = warp_time(ts, s=warp_s)
    return ts


def generate_latents(apply_fn: Callable, shape, generator: torch.Generator,
                     method: str = "rk4", n_steps: int = 50,
                     cond: Optional[dict] = None, cfg_strength: float = 3.0,
                     source=None, init_latents=None, init_strength: float = 0.0,
                     t_scale: float = 999.0, warp_s: Optional[float] = 0.5,
                     dtype=torch.float32, device=None):
    """Integrate from noise (or ``source``, blended with ``init_latents`` at
    ``init_strength``) to data with ``method`` ∈ {'rk4', 'euler', 'heun',
    'midpoint'}. Noise is drawn from ``generator`` on its device unless
    ``source`` is given. Returns ``(latents, nfe)``."""
    if method in _NOT_PORTED:
        raise NotImplementedError(f"sampling method '{method}' is not ported "
                                  "yet (ROADMAP.md)")
    if method not in _STEPS:
        raise ValueError(f"unknown sampling method {method!r}")
    step, evals = _STEPS[method]
    if source is not None:
        x = source
    else:
        x = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                        device=device if device is not None else generator.device)
    if init_latents is not None:
        x = (1 - init_strength) * x + init_strength * init_latents
    else:
        init_strength = 0.0
    ts = _time_grid(n_steps, init_strength, warp_s, dtype).tolist()
    v_func = cfg_velocity(apply_fn, cond, cfg_strength, t_scale)
    for t0, t1 in zip(ts[:-1], ts[1:]):
        x = step(v_func, x, t0, t1 - t0)
    return x, (len(ts) - 1) * evals
