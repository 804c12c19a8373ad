"""The trainers' metrics log, the port's own copy of the JSONL backend of
``flocoder_tpu/utils/logging.py``: the same three-call surface (``init`` /
``log`` / ``finish``) writing one JSON object a line to
``<output_dir>/<project>/<run>/metrics.jsonl``, a first ``_config`` line
and then each record with its ``_step`` (the caller's, else a counter of
``log`` calls since the last ``finish``) and ``_t`` (the host clock).

Only the JSONL backend is ported: wandb is installed on neither of the
machines the port runs on, and its backend is not queued (ROADMAP.md). The
trainers call ``init`` unless ``no_wandb`` is set, as the JAX scripts do;
``log`` without an ``init`` writes nothing (the counter still advances, as
in the JAX shim). ``python -m flocoder_torch.utils.plot_metrics
runs/<project>/<run>`` draws the curves.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

__all__ = ["init", "log", "finish", "is_active"]

_state: dict = {"file": None, "step": 0}


def init(project: str = "flocoder-tpu", name: Optional[str] = None,
         config: Optional[dict] = None, output_dir: str = "runs") -> str:
    """Open (append to) ``<output_dir>/<project>/<name or the start
    time>/metrics.jsonl`` and write the config as its ``_config`` record;
    returns the file's path."""
    run_name = name or time.strftime("%Y%m%d-%H%M%S")
    run_dir = os.path.join(output_dir, project, str(run_name))
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "metrics.jsonl")
    _state["file"] = open(path, "a")
    if config:
        _state["file"].write(json.dumps({"_config": _plain(config)}) + "\n")
        _state["file"].flush()
    return path


def _plain(obj: Any) -> Any:
    """JSON-ready values: dicts and sequences walked, tensors and numpy
    scalars by ``item()``, anything else as its string."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "item"):
        try:
            return obj.item()
        except (ValueError, RuntimeError):       # not a single value
            return str(obj)
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    return str(obj)


def log(metrics: dict, step: Optional[int] = None) -> None:
    """Write ``metrics`` with ``_step`` and ``_t`` when a log is open."""
    if _state["file"] is not None:
        rec = _plain(metrics)
        rec["_step"] = step if step is not None else _state["step"]
        rec["_t"] = time.time()
        _state["file"].write(json.dumps(rec) + "\n")
        _state["file"].flush()
    _state["step"] += 1


def finish() -> None:
    """Close the log and reset the step counter."""
    if _state["file"] is not None:
        _state["file"].close()
    _state.update({"file": None, "step": 0})


def is_active() -> bool:
    return _state["file"] is not None
