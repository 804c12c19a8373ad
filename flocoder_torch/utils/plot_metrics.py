"""Training curves from the metrics log, the port's own copy of
``flocoder_tpu/utils/plot_metrics.py``: ``load_jsonl`` reads
``metrics.jsonl`` (``utils/logging.py``) into ``{metric: (steps,
values)}``, and ``plot_run`` draws every numeric series with more than one
point (``epoch`` and ``nfe`` aside) into ``<run>/curves.png`` (matplotlib).

CLI: ``python -m flocoder_torch.utils.plot_metrics runs/<project>/<run>``
"""
from __future__ import annotations

import json
import os
import sys
from collections import defaultdict

__all__ = ["load_jsonl", "plot_run"]


def load_jsonl(path: str) -> dict:
    """metrics.jsonl → {metric_name: (steps, values)}."""
    series = defaultdict(lambda: ([], []))
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "_config" in rec:
                continue
            step = rec.get("_step", 0)
            for k, v in rec.items():
                if k.startswith("_"):
                    continue
                if isinstance(v, (int, float)):
                    series[k][0].append(step)
                    series[k][1].append(v)
    return dict(series)


def plot_run(run_dir: str, out_path: str | None = None) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = os.path.join(run_dir, "metrics.jsonl")
    series = {k: v for k, v in load_jsonl(path).items()
              if k not in ("epoch", "nfe") and len(v[0]) > 1}
    if not series:
        raise SystemExit(f"no plottable series in {path}")
    n = len(series)
    ncols = min(3, n)
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(4.2 * ncols, 3 * nrows),
                             squeeze=False)
    for ax, (name, (xs, ys)) in zip(axes.flat, sorted(series.items())):
        ax.plot(xs, ys, lw=1.2)
        ax.set_title(name, fontsize=9)
        ax.grid(alpha=0.3)
    for ax in axes.flat[n:]:
        ax.axis("off")
    fig.tight_layout()
    out_path = out_path or os.path.join(run_dir, "curves.png")
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    print(f"wrote {out_path}")
    return out_path


if __name__ == "__main__":
    plot_run(sys.argv[1])
