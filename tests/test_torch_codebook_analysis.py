"""The port's codebook analysis (flocoder_torch.utils.codebook_analysis,
utils.interactive_scatter) against the JAX package's on the same tracker
counts and the same codebooks: the cases of ``tests/test_codebook_analysis.py``
as parity cases. Held exactly: the usage numbers, the pair-combination
matrix, the figure inventory (file names), the records each writes to an
open metrics log (their keys, in order, and every value but the figures'
paths, which name each package's folder), and the interactive HTML twins
byte for byte. A drawing failure is printed and does not stop the caller.
The HTML writer needs numpy and json only (checked in a subprocess with
matplotlib blocked).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.utils import codebook_analysis as jca
from flocoder_tpu.utils import logging as jlog
from flocoder_torch.ops.rvq import RVQState
from flocoder_torch.utils import codebook_analysis as tca
from flocoder_torch.utils import logging as tlog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counts(mod, K=8, L=3):
    t = mod.CodebookUsageTracker(num_levels=L, codebook_size=K)
    rng = np.random.default_rng(0)
    t.update_counts("train", rng.integers(0, K, (64, L)))
    t.update_counts("val", rng.integers(0, K // 2, (32, L)))
    return t


def _vq(D=4, L=3, K=8):
    """The same codebooks as the port's RVQ state and as JAX's."""
    cbs = np.random.default_rng(1).normal(size=(L, K, D)).astype(np.float32)
    port = RVQState(L, K, D)
    port.codebooks.copy_(torch.from_numpy(cbs))
    jax_state = JaxRVQState(codebooks=jnp.asarray(cbs), ema_counts=jnp.ones((L, K)),
                            ema_sums=jnp.asarray(cbs), initted=jnp.asarray(True))
    return port, jax_state


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_pair_combo_matrix_decomposes_keys():
    K, L = 4, 3
    for mod in (tca, jca):
        t = mod.CodebookUsageTracker(num_levels=L, codebook_size=K)
        t.update_counts("train", np.array([[1, 2, 3], [1, 2, 0]]))
        mat = t.pair_combo_matrix("train")
        assert mat[1, 2] == 2 and mat.sum() == 2
    assert np.array_equal(_counts(tca).pair_combo_matrix("val"),
                          _counts(jca).pair_combo_matrix("val"))


def test_combo_map_and_scatters_render(tmp_path):
    vq, jvq = _vq()
    for mod, state, d in ((tca, vq, tmp_path / "t"), (jca, jvq, tmp_path / "j")):
        t = _counts(mod)
        paths = [mod.plot_combo_usage_map(t, epoch=1, output_dir=str(d), use_wandb=False),
                 mod.plot_zq_3d_scatter(t, state, epoch=1, output_dir=str(d), use_wandb=False),
                 mod.plot_zq_3d_frequency_scatter(t, state, "train", epoch=1,
                                                  output_dir=str(d), use_wandb=False)]
        for p in paths:
            assert p is not None and os.path.getsize(p) > 0
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


def test_analyze_writes_the_jax_inventory_and_log(tmp_path):
    """``analyze_codebooks`` with both packages' logs open: the same numbers,
    the same files, the same records."""
    vq, jvq = _vq()
    out = {}
    for name, mod, log, state in (("t", tca, tlog, vq), ("j", jca, jlog, jvq)):
        log.finish()                # the step counter from 0 (earlier tests log too)
        log.init(project="cb", name=name, output_dir=str(tmp_path / "runs"))
        try:
            metrics = mod.analyze_codebooks(_counts(mod), state, epoch=2, use_wandb=True,
                                            output_dir=str(tmp_path / name))
        finally:
            log.finish()
        out[name] = (metrics, sorted(os.listdir(tmp_path / name)),
                     _records(tmp_path / "runs" / "cb" / name / "metrics.jsonl"))
    (m, files, recs), (jm, jfiles, jrecs) = out["t"], out["j"]
    assert m == jm and "train_usage_pct_level0" in m and "val_only_codes" in m
    assert files == jfiles
    for stem in ("codebook_usage_epoch2", "codebook_combos_epoch2",
                 "codebook_vectors_epoch2", "codebook_3d_epoch2", "zq_3d_scatter_epoch2",
                 "zq_3d_freq_train_log_epoch2", "zq_3d_freq_val_log_epoch2"):
        assert any(f.startswith(stem) for f in files), (stem, files)
    assert [list(r) for r in recs] == [list(r) for r in jrecs]
    for r, jr in zip(recs, jrecs):
        for k, v in jr.items():
            if k == "_t":
                continue
            if isinstance(v, str) and v.startswith(str(tmp_path)):
                assert os.path.basename(r[k]) == os.path.basename(v), k
            else:
                assert r[k] == v, k
    assert any(k.startswith("codebook/") for r in recs for k in r)
    for f in files:
        if f.endswith(".html"):
            assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f


def test_combo_map_needs_two_datasets(tmp_path):
    for mod in (tca, jca):
        t = mod.CodebookUsageTracker(num_levels=2, codebook_size=4)
        t.update_counts("train", np.zeros((4, 2), int))
        assert mod.plot_combo_usage_map(t, 0, str(tmp_path), False) is None


def test_scatter_skips_low_dim_embeddings(tmp_path):
    vq, jvq = _vq(D=2)
    assert tca.plot_zq_3d_scatter(_counts(tca), vq, 0, str(tmp_path), False) is None
    assert jca.plot_zq_3d_scatter(_counts(jca), jvq, 0, str(tmp_path), False) is None


def test_interactive_html_twins_written(tmp_path):
    vq, _ = _vq()
    t = _counts(tca)
    tca.plot_zq_3d_scatter(t, vq, epoch=3, output_dir=str(tmp_path), use_wandb=False)
    tca.plot_zq_3d_frequency_scatter(t, vq, "train", epoch=3, output_dir=str(tmp_path),
                                     use_wandb=False)
    freq = tmp_path / "zq_3d_freq_train_log_epoch3.html"
    for p in (tmp_path / "zq_3d_scatter_epoch3.html", freq):
        html = p.read_text()
        assert "<canvas" in html and "DATA=" in html and "pts" in html
        assert "http" not in html.split("<script>")[1]
    assert '"vals"' in freq.read_text()


def test_export_scatter3d_html_needs_numpy_and_json_only(tmp_path):
    """With matplotlib blocked the writer still writes; an empty trace list
    gives None."""
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "from flocoder_torch.utils.interactive_scatter import export_scatter3d_html as f\n"
        f"assert f({str(tmp_path / 'x.html')!r}, [{{'name': 'e', 'points': np.zeros((0, 3))}}])"
        " is None\n"
        f"print(f({str(tmp_path / 'y.html')!r}, [{{'name': 'a', 'points': np.ones((2, 3))}}]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip().endswith("y.html") and not (tmp_path / "x.html").exists()


def test_a_plotting_failure_is_printed_and_training_goes_on(tmp_path, monkeypatch, capsys):
    def broken(*a, **k):
        raise RuntimeError("no display")

    monkeypatch.setattr(tca, "plot_usage_histograms", broken)
    metrics = tca.analyze_codebooks(_counts(tca), None, epoch=1, use_wandb=False,
                                    output_dir=str(tmp_path))
    assert "train_combos_used" in metrics
    assert "codebook plots skipped: RuntimeError: no display" in capsys.readouterr().out
