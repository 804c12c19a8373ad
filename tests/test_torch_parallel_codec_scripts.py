"""``train_vqgan`` and ``train_audio_codec`` on 2 gloo ranks at the smoke
size, ``+device=cpu``: each rank trains on its slice of every epoch's
shuffle (the warmup or reconstruction epoch, then the GAN epoch), the
losses each epoch reports are the ranks' mean and so the same on both,
the codebook tracker counts the indices of every rank, and rank 0 alone
writes the checkpoint, which holds the codec both ranks hold.
"""
import os

import numpy as np
import pytest
import torch

from flocoder_torch.training.checkpoint import load_checkpoint
from test_torch_parallel_ranks import run_ranks, script_rank

AUDIO = ["codec.strides=[2,4]", "codec.base_channels=4", "codec.crop_len=512",
         "codec.fft_sizes=[64,128,256]", "codec.n_mels=[16,32,64]", "codec.disc_periods=[2,3]",
         "codec.disc_scales=2", "codec.disc_base_channels=4", "codec.batch_size=4",
         "codec.epochs=2", "codec.gan_warmup_epochs=1", "+synthetic_n=16", "no_wandb=true"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("module", ["train_vqgan", "train_audio_codec"])
def test_two_rank_codec_training(tmp_path, module):
    if module == "train_vqgan":
        argv = ["--config-name", "smoke_vqgan", "+device=cpu", f"data={tmp_path}/synth",
                "codec.batch_size=32", "codec.hidden_channels=16", "codec.internal_dim=8",
                "image_size=16", "codec.image_size=16",
                "codec.epochs=2", "codec.warmup_epochs=1"]
    else:
        argv = ["--config-name", "audio_dac", "+device=cpu", f"data={tmp_path}/chords", *AUDIO]
    argv += [f"+ckpt_dir={tmp_path}/ck", f"+output_dir={tmp_path}/out"]
    res = run_ranks(script_rank, 2, tmp_path, module, argv, 0)
    for a, b in zip(res[0]["epochs"], res[1]["epochs"]):
        assert a == b and all(np.isfinite(v) for k, v in a.items() if k not in ("epoch", "phase"))
    assert [e["phase"] for e in res[0]["epochs"]] == (
        ["warmup", "gan"] if module == "train_vqgan" else ["recon", "gan"])
    assert res[1]["checkpoint"] is None and os.path.exists(res[0]["checkpoint"])
    assert res[0]["val"] and not res[1]["val"]
    assert sorted(os.listdir(f"{tmp_path}/ck")) == [os.path.basename(res[0]["checkpoint"])]
    assert load_checkpoint(res[0]["checkpoint"])["epoch"] == 2
