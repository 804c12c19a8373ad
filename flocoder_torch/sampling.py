"""ODE sampling for latent flow matching, PyTorch port of
``flocoder_tpu/sampling.py``.

The JAX package scans one jitted step over a precomputed warped time grid;
here the scan is a Python loop over the same grid (held as Python floats, so
the loop never waits on the device). Classifier-free guidance evaluates the
cond and uncond branches in one batched forward. Randomness comes from an
explicit ``torch.Generator``; tests pass ``source`` to compare with JAX.

Methods: Euler, RK4, Heun and midpoint; AB4 (4th-order Adams–Bashforth
after an RK4 bootstrap, weights solved for the warped grid); the SDE
sampler (Euler–Maruyama with churn g(t) = noise_scale·(1−t), its noise from
the generator or passed in as ``noise``); MeanFlow (average-velocity
segments, dual-time models); adaptive Dormand–Prince RK45, whose
``lax.while_loop`` is a host loop here (one host check of t a step). All
take ``source=``; all but RK45 take ``init_latents``/``init_strength``.
All arrays NHWC.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

__all__ = ["warp_time", "euler_step", "rk4_step", "heun_step",
           "midpoint_step", "cfg_velocity", "generate_latents",
           "generate_latents_sde", "generate_latents_meanflow",
           "generate_latents_ab4", "generate_latents_rk45"]


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
        if cond.get("mask_cond") is not None:
            cond2["mask_cond"] = torch.cat([cond["mask_cond"]] * 2)
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


def _start(shape, generator, source, init_latents, init_strength, dtype, device):
    """The integration's start, and the init strength that applies."""
    if source is not None:
        x = source
    else:
        x = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                        device=device if device is not None else generator.device)
    if init_latents is None:
        return x, 0.0
    return (1 - init_strength) * x + init_strength * init_latents, init_strength


def generate_latents_sde(apply_fn: Callable, x, ts: list, generator=None,
                         cond: Optional[dict] = None, cfg_strength: float = 3.0,
                         t_scale: float = 999.0, noise_scale: float = 0.8,
                         noise=None):
    """Stochastic sampler from the same flow: the score of the linear path
    is (t·v − x)/(1 − t), so dx = [v + g²/2·s] dt + g dW with g(t) =
    noise_scale·(1 − t) shares the ODE's marginals; Euler–Maruyama over
    the grid ``ts``. ``noise`` (n_intervals, *x.shape) replaces the
    generator's draws. 1 NFE a step; ``noise_scale=0`` is Euler."""
    v_func = cfg_velocity(apply_fn, cond, cfg_strength, t_scale)
    g2_half = 0.5 * noise_scale * noise_scale
    for i, (t0, t1) in enumerate(zip(ts[:-1], ts[1:])):
        dt = t1 - t0
        v = v_func(x, t0)
        x = x + (v + g2_half * (1 - t0) * (t0 * v - x)) * dt
        if noise_scale > 0:
            xi = (noise[i] if noise is not None else
                  torch.randn(x.shape, generator=generator, dtype=x.dtype,
                              device=x.device))
            x = x + noise_scale * (1 - t0) * math.sqrt(dt) * xi
    return x, len(ts) - 1


def generate_latents_meanflow(apply_fn: Callable, x, ts: list,
                              cond: Optional[dict] = None,
                              cfg_strength: float = 0.0, t_scale: float = 999.0):
    """Average-velocity segments x ← x + (t₁ − t₀)·u(x, t₀, t₁), the
    horizon t₁ riding in ``cond['time_horizon']``. One NFE a segment."""
    base = dict(cond) if cond else {}
    for t0, t1 in zip(ts[:-1], ts[1:]):
        c = dict(base)
        c["time_horizon"] = torch.full((x.shape[0],), t1, dtype=x.dtype,
                                       device=x.device) * t_scale
        x = x + (t1 - t0) * cfg_velocity(apply_fn, c, cfg_strength, t_scale)(x, t0)
    return x, len(ts) - 1


def _ab4_coefficients(ts: torch.Tensor) -> torch.Tensor:
    """Variable-step Adams–Bashforth-4 weights on a (warped) grid: row i
    weighs f at t_{i..i+3} (oldest first) to step from t_{i+3} to t_{i+4};
    the integral of the cubic through them, from a 4×4 Vandermonde moment
    system shifted to the newest node."""
    n = ts.shape[0] - 1
    idx = torch.arange(3, n)
    tau = torch.stack([ts[idx - 3], ts[idx - 2], ts[idx - 1], ts[idx]], 1) - ts[idx][:, None]
    dt1 = (ts[idx + 1] - ts[idx])[:, None]
    k = torch.arange(4)[None, :]
    vand = tau[:, None, :] ** torch.arange(4)[None, :, None]
    moments = dt1 ** (k + 1) / (k + 1)
    return torch.linalg.solve(vand, moments[..., None])[..., 0]


def generate_latents_ab4(apply_fn: Callable, x, ts: torch.Tensor,
                         cond: Optional[dict] = None, cfg_strength: float = 3.0,
                         t_scale: float = 999.0):
    """Adams–Bashforth-4: an RK4 bootstrap over the first three intervals
    (whose k1 evaluations are the history), then one NFE a step. Plain RK4
    when the grid has fewer than five points. NFE = 12 + (intervals − 3)."""
    v_func = cfg_velocity(apply_fn, cond, cfg_strength, t_scale)
    t = ts.tolist()
    n = len(t) - 1
    if n < 4:
        for t0, t1 in zip(t[:-1], t[1:]):
            x = rk4_step(v_func, x, t0, t1 - t0)
        return x, n * 4
    hist = []
    for i in range(3):
        t0, dt = t[i], t[i + 1] - t[i]
        k1 = v_func(x, t0)
        k2 = v_func(x + dt * k1 / 2, t0 + dt / 2)
        k3 = v_func(x + dt * k2 / 2, t0 + dt / 2)
        k4 = v_func(x + dt * k3, t0 + dt)
        hist.append(k1)
        x = x + (dt / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
    coeffs = _ab4_coefficients(ts).to(x.device, x.dtype)
    for j, t_i in enumerate(t[3:-1]):
        hist.append(v_func(x, t_i))
        c = coeffs[j]
        x = x + (c[0] * hist[0] + c[1] * hist[1] + c[2] * hist[2] + c[3] * hist[3])
        hist = hist[1:]
    return x, 12 + (n - 3)


# Dormand–Prince RK45 Butcher tableau.
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)


def generate_latents_rk45(apply_fn: Callable, x, cond: Optional[dict] = None,
                          cfg_strength: float = 3.0, rtol: float = 1e-3,
                          atol: float = 1e-4, max_steps: int = 1000,
                          t_scale: float = 999.0):
    """Adaptive Dormand–Prince RK45 from t=0 to 1 with one scalar step size,
    controlled by the RMS error norm over the whole batch. t and dt are
    fp32 device scalars as in the JAX loop; the host reads t once a step.
    Returns ``(latents, nfe)``, 6 NFE counted a step as the JAX package
    counts them."""
    v_func = cfg_velocity(apply_fn, cond, cfg_strength, t_scale)
    t = torch.zeros((), dtype=x.dtype, device=x.device)
    dt = torch.full((), 0.05, dtype=x.dtype, device=x.device)
    steps = 0
    while steps < max_steps and bool(t < 1.0):
        dt = torch.minimum(dt, 1.0 - t)
        ks = []
        for i in range(7):
            xi = x
            for j, a in enumerate(_DP_A[i]):
                xi = xi + dt * a * ks[j]
            ks.append(v_func(xi, t + _DP_C[i] * dt))
        x5, x4 = x, x
        for i in range(7):
            x5 = x5 + dt * _DP_B5[i] * ks[i]
            x4 = x4 + dt * _DP_B4[i] * ks[i]
        scale = atol + rtol * torch.maximum(x.abs(), x5.abs())
        norm = (((x5 - x4) / scale) ** 2).mean().sqrt()
        accept = norm <= 1.0
        factor = (0.9 * torch.where(norm > 0, norm, 1e-10) ** -0.2).clamp(0.2, 5.0)
        x = torch.where(accept, x5, x)
        t = torch.where(accept, t + dt, t)
        dt = (dt * factor).clamp(1e-5, 1.0)
        steps += 1
    return x, 6 * steps


def generate_latents(apply_fn: Callable, shape, generator: torch.Generator,
                     method: str = "rk4", n_steps: int = 50,
                     cond: Optional[dict] = None, cfg_strength: float = 3.0,
                     source=None, init_latents=None, init_strength: float = 0.0,
                     t_scale: float = 999.0, warp_s: Optional[float] = 0.5,
                     dtype=torch.float32, device=None, noise=None):
    """Integrate from noise (or ``source``, blended with ``init_latents`` at
    ``init_strength``) to data with ``method`` ∈ {'rk4', 'euler', 'heun',
    'midpoint', 'ab4', 'sde', 'meanflow', 'rk45'}. Noise is drawn from
    ``generator`` on its device unless ``source`` is given (and, for 'sde',
    ``noise``). For 'meanflow', ``n_steps`` counts segments; 'rk45' is
    adaptive and ignores the grid and the init latents. Returns
    ``(latents, nfe)``."""
    if method not in _STEPS and method not in ("ab4", "sde", "meanflow", "rk45"):
        raise ValueError(f"unknown sampling method {method!r}")
    if method == "rk45":
        x, _ = _start(shape, generator, source, None, 0.0, dtype, device)
        return generate_latents_rk45(apply_fn, x, cond=cond,
                                     cfg_strength=cfg_strength, t_scale=t_scale)
    x, init_strength = _start(shape, generator, source, init_latents,
                              init_strength, dtype, device)
    if method == "meanflow":
        ts = _time_grid(max(n_steps + 1, 2), init_strength, warp_s, dtype)
        return generate_latents_meanflow(apply_fn, x, ts.tolist(), cond=cond,
                                         cfg_strength=cfg_strength, t_scale=t_scale)
    ts = _time_grid(n_steps, init_strength, warp_s, dtype)
    if method == "ab4":
        return generate_latents_ab4(apply_fn, x, ts, cond=cond,
                                    cfg_strength=cfg_strength, t_scale=t_scale)
    if method == "sde":
        return generate_latents_sde(apply_fn, x, ts.tolist(), generator, cond=cond,
                                    cfg_strength=cfg_strength, t_scale=t_scale,
                                    noise=noise)
    step, evals = _STEPS[method]
    ts = ts.tolist()
    v_func = cfg_velocity(apply_fn, cond, cfg_strength, t_scale)
    for t0, t1 in zip(ts[:-1], ts[1:]):
        x = step(v_func, x, t0, t1 - t0)
    return x, (len(ts) - 1) * evals
