"""``train_vqgan``'s metrics log against the JAX script's: ``smoke_vqgan``
at 16² (hidden 16, one downsample, RVQ 2×16×4) with ``no_wandb=false`` on
the same folder of 40 seeded PNGs, one warmup epoch of 4 steps (batch 8)
with its validation: ``train/…``, ``val/…`` and ``demo/recon``. Each
package runs in a working directory of its own; every record has the same
set of keys, record for record. The JAX script runs on a one-device mesh
with its codec's init compiled whole (``test_torch_logging.py``'s helpers;
its step compiles take most of this file's time). The codebook records and
figures of a trainer's 10th epoch are held in
``test_torch_logging_audio.py``, and ``analyze_codebooks``' records and
figures against JAX's in ``test_torch_codebook_analysis.py``.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models.codecs import VQVAE as JaxVQVAE
from flocoder_torch import train_vqgan as tv

from test_torch_logging import (ROOT, assert_same_keys, jit_init, load_script,
                                one_device_mesh, records, the_log, workdir)

OVER = ["no_wandb=false", "codec.image_size=16", "image_size=16", "codec.batch_size=8",
        "codec.hidden_channels=16", "codec.internal_dim=16", "codec.num_downsamples=1",
        "codec.epochs=1", "codec.warmup_epochs=1", "num_workers=1", "run_name=r"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_vqgan_logs_the_jax_keys(tmp_path, monkeypatch):
    data = tmp_path / "pngs" / "a"
    data.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(40):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
            data / f"{i:02d}.png")
    over = [f"data={tmp_path / 'pngs'}", *OVER]
    one_device_mesh(monkeypatch)
    jit_init(monkeypatch, JaxVQVAE)

    workdir(tmp_path / "t", monkeypatch)
    res = tv.main(["--config-name", "smoke_vqgan", "+device=cpu", *over])
    ours = records(res["metrics_log"])
    workdir(tmp_path / "j", monkeypatch)
    load_script("train_vqgan").train_vqgan(
        jload_config("smoke_vqgan", os.path.join(ROOT, "configs"), over))
    ref = records(the_log(tmp_path / "j"))

    assert os.path.join(tmp_path / "j", res["metrics_log"]) == the_log(tmp_path / "j")
    assert_same_keys(ours, ref)
    keys = [k for r in ours for k in r]
    assert {"train/total", "train/mse", "samples_per_sec", "val/total", "demo/recon"} <= set(keys)
    assert ours[-1]["demo/recon"] == os.path.join("output_vqgan_pngs", "recon_epoch1.png")
