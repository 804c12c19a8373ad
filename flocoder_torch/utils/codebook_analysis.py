"""Codebook usage analytics, the port's own copy of
``flocoder_tpu/utils/codebook_analysis.py``.

``CodebookUsageTracker`` counts each dataset's ('train', 'val', 'gen')
codes per level and the level combinations; ``analyze_codebooks`` prints
and logs the usage numbers (``codebook/…`` through ``utils/logging.py``)
and draws the JAX module's figures under the same file names: per-level
usage histograms (``codebook_usage_epoch{e}.png``), the level-0 × level-1
combination maps of the first two datasets
(``codebook_combos_epoch{e}.png``) and, given the codebooks, their heatmaps
(``codebook_vectors_epoch{e}.png``, ``codebook_3d_epoch{e}.png``) and 3-D
scatters of the composed vectors (``zq_3d_scatter_epoch{e}.{png,html}``,
``zq_3d_freq_<name>_log_epoch{e}.{png,html}``; the HTML twins from
``utils/interactive_scatter.py``). The codebooks are the codec's RVQ state
(``codec.vq``: an object with ``codebooks`` (L, K, D), a tensor on any
device, or an array), where the JAX trainers pass ``state.params["vq"]``.
As in the JAX module, a failure while drawing is printed (``codebook plots
skipped: …``) and training goes on: plotting must never stop it.
"""
from __future__ import annotations

import os

import numpy as np

from . import logging as wblog

__all__ = ["CodebookUsageTracker", "plot_usage_histograms",
           "plot_combo_usage_map", "plot_zq_3d_scatter",
           "plot_zq_3d_frequency_scatter",
           "viz_codebook_vectors", "analyze_codebooks"]


def _codebooks(vq_state) -> np.ndarray:
    """(L, K, D) fp32 codebooks of an RVQ state, from any device."""
    cbs = vq_state.codebooks
    if hasattr(cbs, "detach"):
        cbs = cbs.detach().float().cpu().numpy()
    return np.asarray(cbs)


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

    def pair_combo_matrix(self, name: str) -> np.ndarray:
        """(K, K) count matrix of (level-0, level-1) code pairs, decomposed
        from the base-K composite keys (level 0 is the most significant
        digit). The 2-D view the reference's combo maps plot
        (codebook_analysis.py:161-235)."""
        self._ensure(name)
        K, L = self.codebook_size, self.num_levels
        mat = np.zeros((K, K), dtype=np.int64)
        for key, c in self.combo_counts[name].items():
            i = key // K ** (L - 1)
            j = (key // K ** (L - 2)) % K if L >= 2 else 0
            mat[i, j] += c
        return mat

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

    def analyze(self, codec_vq_state=None, epoch: int = 0,
                use_wandb: bool = True, output_dir: str = "./"):
        """The numbers, printed and (``use_wandb``) logged, then the
        figures (module docstring); returns the numbers."""
        metrics = {}
        for name in self.counts:
            metrics.update(self.usage_stats(name))
        metrics.update(self.val_only_stats())
        print(f"  codebooks (epoch {epoch}): " + "  ".join(
            f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in metrics.items()), flush=True)
        if use_wandb:
            wblog.log({f"codebook/{k}": v for k, v in metrics.items()}
                      | {"epoch": epoch})
        try:
            plot_usage_histograms(self, epoch, output_dir, use_wandb)
            if len(self.counts) >= 2:
                plot_combo_usage_map(self, epoch, output_dir, use_wandb)
            if codec_vq_state is not None:
                viz_codebook_vectors(codec_vq_state, epoch, output_dir,
                                     use_wandb)
                if len(self.counts) >= 2:
                    plot_zq_3d_scatter(self, codec_vq_state, epoch,
                                       output_dir, use_wandb)
                for name in self.counts:
                    plot_zq_3d_frequency_scatter(self, codec_vq_state, name,
                                                 epoch, output_dir, use_wandb)
        except Exception as e:  # plotting must never stop training
            print(f"codebook plots skipped: {type(e).__name__}: {e}", flush=True)
        return metrics


def plot_usage_histograms(tracker: CodebookUsageTracker, epoch: int,
                          output_dir: str = "./", use_wandb: bool = True):
    """Per-level usage histograms (reference: codebook_analysis.py:115-157)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    L = tracker.num_levels
    fig, axes = plt.subplots(len(tracker.counts) or 1, L,
                             figsize=(3 * L, 2.5 * max(len(tracker.counts), 1)),
                             squeeze=False)
    for r, (name, counts) in enumerate(sorted(tracker.counts.items())):
        for l in range(L):
            ax = axes[r][l]
            ax.bar(np.arange(tracker.codebook_size), counts[l], width=1.0)
            ax.set_title(f"{name} L{l} "
                         f"({(counts[l] > 0).mean() * 100:.0f}% used)",
                         fontsize=8)
            ax.tick_params(labelsize=6)
    fig.tight_layout()
    path = os.path.join(output_dir, f"codebook_usage_epoch{epoch}.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    if use_wandb:
        wblog.log({"codebook/usage_hist": path, "epoch": epoch})
    return path


def plot_combo_usage_map(tracker: CodebookUsageTracker, epoch: int,
                         output_dir: str = "./", use_wandb: bool = True):
    """6-panel (level-0 × level-1) combo maps for the first two tracked
    datasets (reference: codebook_analysis.py:161-235): a categorical
    usage map (unused / first-only / second-only / both, with unused %)
    plus linear- and log-frequency heatmaps per dataset."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import gridspec
    from matplotlib.colors import ListedColormap
    from matplotlib.patches import Patch

    names = sorted(tracker.counts)[:2]
    if len(names) < 2:
        return None
    os.makedirs(output_dir, exist_ok=True)
    n1, n2 = names
    f1 = tracker.pair_combo_matrix(n1).astype(float)
    f2 = tracker.pair_combo_matrix(n2).astype(float)
    cat = np.zeros_like(f1, dtype=int)  # 0 unused, 1 first, 2 second, 3 both
    cat[f1 > 0] = 1
    cat[(f2 > 0) & (f1 == 0)] = 2
    cat[(f1 > 0) & (f2 > 0)] = 3

    fig = plt.figure(figsize=(18, 10))
    gs = gridspec.GridSpec(2, 3, width_ratios=[1, 1.3, 1.3])
    axs = [fig.add_subplot(gs[i // 3, i % 3]) for i in range(6)]
    for ax in axs:
        ax.set_xlabel("Level 0 Codebook Index")
        ax.set_ylabel("Level 1 Codebook Index")

    cmap_cat = ListedColormap(["white", "blue", "red", "purple"])
    axs[0].imshow(cat.T, cmap=cmap_cat, vmin=0, vmax=3, origin="lower")
    axs[0].set_title("Usage Categories")
    axs[0].legend(handles=[
        Patch(facecolor="white", edgecolor="black", label="Unused"),
        Patch(facecolor="blue", label=f"{n1} only"),
        Patch(facecolor="red", label=f"{n2} only"),
        Patch(facecolor="purple", label="Both")],
        loc="center left", bbox_to_anchor=(1.02, 0.5))
    unused_pct = (cat == 0).mean() * 100
    axs[0].text(1.02, 0.3, f"Unused = {unused_pct:.1f}%",
                transform=axs[0].transAxes, fontsize=10)

    for i, (name, freq) in enumerate(((n1, f1), (n2, f2))):
        cmap = ["Blues", "Reds"][i]
        im = axs[i + 1].imshow(freq.T, cmap=cmap, origin="lower")
        axs[i + 1].set_title(f"{name} Frequency")
        fig.colorbar(im, ax=axs[i + 1], label="Usage Count", shrink=0.6)
        im = axs[i + 4].imshow(np.log10(1 + freq).T, cmap=cmap,
                               origin="lower")
        axs[i + 4].set_title(f"{name} Frequency (Log)")
        fig.colorbar(im, ax=axs[i + 4], label="log10(1 + Usage Count)",
                     shrink=0.6)
    axs[3].set_visible(False)
    fig.suptitle(f"Codebook Combinations (Epoch {epoch})")
    fig.tight_layout()
    path = os.path.join(output_dir, f"codebook_combos_epoch{epoch}.png")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    if use_wandb:
        wblog.log({"codebook/combination_usage_map": path, "epoch": epoch})
    return path


def _composed_points(vq_state, mat: np.ndarray):
    """Combo matrix → (points (N, D), counts (N,)) of composed L0+L1
    codebook vectors for used combos (reference zq scatter inputs)."""
    cbs = _codebooks(vq_state)
    ii, jj = np.nonzero(mat)
    if len(ii) == 0:
        return np.zeros((0, cbs.shape[-1])), np.zeros((0,))
    return cbs[0][ii] + cbs[1][jj], mat[ii, jj]


def plot_zq_3d_scatter(tracker: CodebookUsageTracker, vq_state, epoch: int,
                       output_dir: str = "./", use_wandb: bool = True):
    """Categorical 3-D scatter of composed quantized vectors for the first
    two tracked datasets, overlaps in purple (reference:
    codebook_analysis.py:237-290 — plotly there; here a static matplotlib
    3-D PNG plus a dependency-free INTERACTIVE .html twin
    (utils/interactive_scatter.py: drag-rotate/zoom/hover, no plotly
    needed), closing the interactive-widget gap)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from .interactive_scatter import export_scatter3d_html

    names = sorted(tracker.counts)[:2]
    if len(names) < 2 or _codebooks(vq_state).shape[-1] < 3:
        return None
    os.makedirs(output_dir, exist_ok=True)
    m1 = tracker.pair_combo_matrix(names[0])
    m2 = tracker.pair_combo_matrix(names[1])
    both = (m1 > 0) & (m2 > 0)
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    html_traces = []
    for mat, color, label in ((np.where(both, 0, m1), "blue", names[0]),
                              (np.where(both, 0, m2), "red", names[1]),
                              (both.astype(int), "purple", "Both")):
        pts, _ = _composed_points(vq_state, mat)
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=color, s=10,
                       alpha=0.6, label=label)
            html_traces.append({"name": label, "points": pts,
                                "color": color})
    export_scatter3d_html(
        os.path.join(output_dir, f"zq_3d_scatter_epoch{epoch}.html"),
        html_traces, title=f"Quantized vectors (epoch {epoch})")
    ax.set_title(f"Quantized Vectors in 3D Space (Epoch {epoch})")
    ax.set_xlabel("Embedding Dim 0")
    ax.set_ylabel("Embedding Dim 1")
    ax.set_zlabel("Embedding Dim 2")
    ax.legend()
    path = os.path.join(output_dir, f"zq_3d_scatter_epoch{epoch}.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    if use_wandb:
        wblog.log({"codebook/zq_3d_scatter": path, "epoch": epoch})
    return path


def plot_zq_3d_frequency_scatter(tracker: CodebookUsageTracker, vq_state,
                                 name: str, epoch: int,
                                 output_dir: str = "./",
                                 use_wandb: bool = True,
                                 use_log: bool = True):
    """Frequency-colored 3-D scatter of one dataset's composed vectors
    (reference: codebook_analysis.py:292-333; static PNG + interactive
    dependency-free .html twin, see plot_zq_3d_scatter)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from .interactive_scatter import export_scatter3d_html

    if _codebooks(vq_state).shape[-1] < 3:
        return None
    pts, counts = _composed_points(vq_state,
                                   tracker.pair_combo_matrix(name))
    if len(pts) == 0:
        return None
    os.makedirs(output_dir, exist_ok=True)
    cvals = np.log10(1 + counts) if use_log else counts
    export_scatter3d_html(
        os.path.join(output_dir,
                     f"zq_3d_freq_{name}{'_log' if use_log else ''}"
                     f"_epoch{epoch}.html"),
        [{"name": name, "points": pts, "values": cvals,
          "labels": [f"count: {int(c)}" for c in counts]}],
        title=f"{name} combo frequency (epoch {epoch})")
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(projection="3d")
    sc = ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=cvals, s=12,
                    cmap="viridis", alpha=0.8)
    fig.colorbar(sc, ax=ax, shrink=0.6,
                 label="log10(1 + Frequency)" if use_log else "Frequency")
    ax.set_title(f"{name} Frequency in 3D Space (Epoch {epoch})"
                 + (" - Log Scale" if use_log else ""))
    ax.set_xlabel("Embedding Dim 0")
    ax.set_ylabel("Embedding Dim 1")
    ax.set_zlabel("Embedding Dim 2")
    suffix = "_log" if use_log else ""
    path = os.path.join(output_dir,
                        f"zq_3d_freq_{name}{suffix}_epoch{epoch}.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    if use_wandb:
        wblog.log({f"codebook/{name}_3d_frequency_scatter{suffix}": path,
                   "epoch": epoch})
    return path


def viz_codebook_vectors(vq_state, epoch: int, output_dir: str = "./",
                         use_wandb: bool = True):
    """Codebook-vector heatmaps + magnitude histograms per level
    (reference: codebook_analysis.py:335-380); 3-D scatter of composed
    vectors when the embedding dim ≥ 3 (plotly → matplotlib 3-D)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(output_dir, exist_ok=True)
    cbs = _codebooks(vq_state)  # (L, K, D)
    L = cbs.shape[0]
    fig, axes = plt.subplots(2, L, figsize=(3.2 * L, 5), squeeze=False)
    for l in range(L):
        im = axes[0][l].imshow(cbs[l], aspect="auto", cmap="RdBu_r")
        axes[0][l].set_title(f"codebook L{l}", fontsize=8)
        fig.colorbar(im, ax=axes[0][l], fraction=0.046)
        mags = np.linalg.norm(cbs[l], axis=1)
        axes[1][l].hist(mags, bins=24)
        axes[1][l].set_title(f"|v| L{l}", fontsize=8)
    fig.tight_layout()
    path = os.path.join(output_dir, f"codebook_vectors_epoch{epoch}.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)

    path3d = None
    if cbs.shape[-1] >= 3 and L >= 2:
        fig = plt.figure(figsize=(5, 5))
        ax = fig.add_subplot(projection="3d")
        # composed two-level vectors, colored by level-0 id
        comp = (cbs[0][:, None, :] + cbs[1][None, :, :]).reshape(-1, cbs.shape[-1])
        color = np.repeat(np.arange(cbs.shape[1]), cbs.shape[1])
        ax.scatter(comp[:, 0], comp[:, 1], comp[:, 2], c=color, s=4,
                   cmap="tab20")
        ax.set_title("composed codebook vectors (L0+L1)")
        path3d = os.path.join(output_dir, f"codebook_3d_epoch{epoch}.png")
        fig.savefig(path3d, dpi=110)
        plt.close(fig)

    if use_wandb:
        wblog.log({"codebook/vectors": path, "codebook/scatter3d": path3d,
                   "epoch": epoch})
    return path


def analyze_codebooks(tracker: CodebookUsageTracker, vq_state=None,
                      epoch: int = 0, use_wandb: bool = True,
                      output_dir: str = "./"):
    """``tracker.analyze``: the JAX function's signature; ``vq_state`` is
    the codec's RVQ state or None (no codebook figures)."""
    return tracker.analyze(vq_state, epoch, use_wandb, output_dir)
