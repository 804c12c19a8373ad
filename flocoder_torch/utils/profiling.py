"""Memory, tracing, timing and NaN-debugging helpers, the port's own
counterparts of ``flocoder_tpu/utils/profiling.py`` in PyTorch's idiom,
under the same four names:

- ``print_mem``: each CUDA device's bytes in use (``torch.cuda.memory_stats``'
  ``allocated_bytes.all.current``) and its limit (the card's total memory,
  ``torch.cuda.mem_get_info``), printed and returned.
- ``trace(log_dir)``: a ``torch.profiler`` region (CPU, and CUDA where a card
  is present) whose trace handler writes a TensorBoard / Chrome trace into
  ``log_dir``.
- ``step_timer``: wall-clock time of a region with one
  ``torch.cuda.synchronize`` at its end, and none inside.
- ``enable_nan_debugging``: ``torch.autograd.set_detect_anomaly(enable,
  check_nan=True)``. It raises where a backward produces a NaN, naming the
  forward operation; ``jax_debug_nans`` raises at any operation, forward
  included (a deliberate difference, ROADMAP.md §3).
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

__all__ = ["print_mem", "trace", "step_timer", "enable_nan_debugging"]


def print_mem(tag: str = "") -> dict:
    """``{device: (GB in use, GB limit)}`` of every CUDA device, printed;
    empty without a card."""
    stats = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        dev = torch.device("cuda", i)
        used = torch.cuda.memory_stats(dev).get("allocated_bytes.all.current", 0) / 1e9
        limit = torch.cuda.mem_get_info(dev)[1] / 1e9
        stats[str(dev)] = (used, limit)
        print(f"[mem] {tag} {dev}: {used:.2f}/{limit:.2f} GB")
    return stats


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile a region: ``with trace('dir') as prof: run_steps()``, then
    open the trace in TensorBoard or a Chrome trace viewer. Yields the
    profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def step_timer(label: str = "step", device=None):
    """Time a region: yields a dict whose ``seconds`` is set at the end,
    after one ``torch.cuda.synchronize(device)`` when a card is present."""
    t0 = time.perf_counter()
    out = {}
    try:
        yield out
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)
        out["seconds"] = time.perf_counter() - t0
        print(f"[time] {label}: {out['seconds'] * 1e3:.1f} ms")


def enable_nan_debugging(enable: bool = True) -> None:
    """Autograd's anomaly mode with NaN checks in the backward."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
