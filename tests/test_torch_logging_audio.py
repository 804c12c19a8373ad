"""``train_audio_codec``'s metrics log: against the JAX script's on the tiny
DAC of ``test_torch_audio_slice.py`` (synthetic chords, batch 4, one
reconstruction epoch with its validation, ``codec.gan=false``), every
record with the same set of keys, record for record, each package in a
working directory of its own (the JAX script on a one-device mesh, its
codec's init compiled whole); and the port alone over ten epochs, whose
10th writes the codebook analysis: its ``codebook/…`` records (the usage
numbers and the figures' paths) and the figures under the JAX module's
file names, in the WAVs' folder.
"""
import os

import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models.audio_codec import DACCodec as JaxDAC
from flocoder_torch import train_audio_codec as tac

from test_torch_audio_slice import TINY
from test_torch_logging import (ROOT, assert_same_keys, jit_init, load_script,
                                one_device_mesh, records, the_log, workdir)

LOGGED = [*[o for o in TINY if not o.startswith("no_wandb")], "no_wandb=false",
          "codec.batch_size=4", "+synthetic_n=8", "run_name=r"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_audio_codec_logs_the_jax_keys(tmp_path, monkeypatch):
    over = [f"data={tmp_path / 'chords'}", *LOGGED, "codec.epochs=1", "codec.gan=false"]
    one_device_mesh(monkeypatch)
    jit_init(monkeypatch, JaxDAC)
    workdir(tmp_path / "t", monkeypatch)
    res = tac.main(["--config-name", "audio_dac", "+device=cpu", *over])
    ours = records(res["metrics_log"])
    workdir(tmp_path / "j", monkeypatch)
    load_script("train_audio_codec").train_audio_codec(
        jload_config("audio_dac", os.path.join(ROOT, "configs"), over))
    ref = records(the_log(tmp_path / "j"))
    assert os.path.join(tmp_path / "j", res["metrics_log"]) == the_log(tmp_path / "j")
    assert_same_keys(ours, ref)
    keys = {k for r in ours for k in r}
    assert {"train/total", "train/mel", "clips_per_sec", "val/total", "epoch"} <= keys


def test_tenth_epoch_logs_and_draws_the_codebooks(tmp_path, monkeypatch):
    workdir(tmp_path, monkeypatch)
    res = tac.main(["--config-name", "audio_dac", "+device=cpu", f"data={tmp_path / 'chords'}",
                    *LOGGED, "codec.epochs=10", "codec.gan_warmup_epochs=9",
                    "+output_dir=out", "+ckpt_dir=ck"])
    recs = records(res["metrics_log"])
    cb = [r for r in recs if any(k.startswith("codebook/") for k in r)]
    assert cb and all(r["epoch"] == 10 for r in cb)
    keys = {k for r in cb for k in r}
    assert {"codebook/train_usage_pct_level0", "codebook/val_usage_pct_level3",
            "codebook/val_only_codes", "codebook/usage_hist",
            "codebook/combination_usage_map", "codebook/vectors", "codebook/scatter3d",
            "codebook/zq_3d_scatter", "codebook/train_3d_frequency_scatter_log"} <= keys
    # the GAN epoch's record carries its losses
    assert [r["epoch"] for r in recs if "train/gen" in r] == [10]
    assert all({"train/feat", "train/d_loss"} <= set(r) for r in recs if "train/gen" in r)
    files = set(os.listdir(tmp_path / "out"))
    for name in ("codebook_usage_epoch10.png", "codebook_combos_epoch10.png",
                 "codebook_vectors_epoch10.png", "codebook_3d_epoch10.png",
                 "zq_3d_scatter_epoch10.png", "zq_3d_scatter_epoch10.html",
                 "zq_3d_freq_train_log_epoch10.png", "zq_3d_freq_train_log_epoch10.html",
                 "zq_3d_freq_val_log_epoch10.png", "zq_3d_freq_val_log_epoch10.html"):
        assert name in files, (name, sorted(files))
