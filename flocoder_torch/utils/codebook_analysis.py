"""Codebook usage analytics, the port's own copy of the counting part of
``flocoder_tpu/utils/codebook_analysis.py``: ``CodebookUsageTracker``
(per-dataset, per-level code counts and level-combination counts) and
``analyze_codebooks``, which prints and returns the usage numbers. The
matplotlib figures are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np

__all__ = ["CodebookUsageTracker", "analyze_codebooks"]


class CodebookUsageTracker:
    """Per-dataset ('train'/'val'/'gen') per-level code counts + composed
    level-combination counts (reference: codebook_analysis.py:10-61)."""

    def __init__(self, num_levels: int = 4, codebook_size: int = 96):
        self.num_levels = num_levels
        self.codebook_size = codebook_size
        self.reset_all()

    def reset_all(self):
        self.counts = {}
        self.combo_counts = {}

    def _ensure(self, name: str):
        if name not in self.counts:
            self.counts[name] = np.zeros((self.num_levels,
                                          self.codebook_size), np.int64)
            self.combo_counts[name] = {}

    def update_counts(self, name: str, indices):
        """indices: (N, L) int array of per-level code ids."""
        self._ensure(name)
        idx = np.asarray(indices).reshape(-1, self.num_levels)
        for lvl in range(self.num_levels):
            binc = np.bincount(idx[:, lvl], minlength=self.codebook_size)
            self.counts[name][lvl] += binc[:self.codebook_size]
        # combo counts via a single base-K key (device-friendly composition)
        keys = np.zeros(idx.shape[0], np.int64)
        for lvl in range(self.num_levels):
            keys = keys * self.codebook_size + idx[:, lvl]
        uniq, cnt = np.unique(keys, return_counts=True)
        cc = self.combo_counts[name]
        for k, c in zip(uniq.tolist(), cnt.tolist()):
            cc[k] = cc.get(k, 0) + c

    def usage_stats(self, name: str) -> dict:
        """(reference: codebook_analysis.py:86-113)."""
        self._ensure(name)
        counts = self.counts[name]
        used = counts > 0
        stats = {
            f"{name}_usage_pct_level{l}": float(used[l].mean() * 100)
            for l in range(self.num_levels)
        }
        stats[f"{name}_combos_used"] = len(self.combo_counts[name])
        return stats

    def val_only_stats(self) -> dict:
        """Codes/combos seen in val but never in train."""
        out = {}
        if "train" in self.counts and "val" in self.counts:
            t_used = self.counts["train"] > 0
            v_used = self.counts["val"] > 0
            out["val_only_codes"] = int((v_used & ~t_used).sum())
            t_combos = set(self.combo_counts["train"])
            v_combos = set(self.combo_counts["val"])
            out["val_only_combos"] = len(v_combos - t_combos)
        return out


def analyze_codebooks(tracker: CodebookUsageTracker, epoch: int = 0) -> dict:
    """Usage % per level, combinations used, and codes / combinations seen
    in validation only; printed and returned."""
    metrics = {}
    for name in tracker.counts:
        metrics.update(tracker.usage_stats(name))
    metrics.update(tracker.val_only_stats())
    print(f"  codebooks (epoch {epoch}): " + "  ".join(
        f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in metrics.items()))
    return metrics
