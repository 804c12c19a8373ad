"""The bf16 DAC slice at a tiny size on the CPU, through the port's entry
points: ``train_audio_codec +codec.bf16=true`` (one reconstruction and one
GAN epoch), ``preencode_data`` with the bf16 codec, ``train_flow`` with
``flow.bf16=true`` (one epoch with ``evaluate_model_audio`` on the bf16
codec), and ``generate_samples`` of its EMA checkpoint with no ``+bf16``
flag, which serves in bf16 as trained and writes WAVs.

Held against the JAX package: its ``DACCodec`` (built by its
``setup_codec`` from the same config, ``codec.bf16`` set) loads the port's
``dac_`` checkpoint strictly, fp32 parameters in both trees; the root
``preencode_data.py``'s ``process_dataset`` with that checkpoint writes the
same files as the port's, float32 latents within 1e-2 of the largest |ref|
(the bf16 encoder's output, widened by both to fp32; op by op the two agree
bit for bit on this box, ``test_torch_audio_bf16.py``).
"""
import functools
import os
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.data import datasets as jax_datasets
from flocoder_tpu.parallel.mesh import make_mesh
from flocoder_tpu.training import checkpoint as jckpt
from flocoder_torch import generate_samples as gs
from flocoder_torch import preencode_data as pe
from flocoder_torch import train_audio_codec as tac
from flocoder_torch import train_flow as tf

from test_torch_audio_slice import ROOT, TINY, _jax_template, _root_script

BF16 = ["+codec.bf16=true"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_dac_from_codec_training_to_wavs(tmp_path):
    data = str(tmp_path / "chords")                 # absent: the synthetic chords
    common = ["--config-name", "audio_dac", "+device=cpu", f"data={data}", *TINY, *BF16,
              f"+ckpt_dir={tmp_path}/ck"]
    run = tac.main([*common, f"+output_dir={tmp_path}/out", "codec.batch_size=4",
                    "codec.epochs=2", "codec.gan_warmup_epochs=1", "+eval_every=1",
                    "+synthetic_n=16"])
    codec = run["state"].codec
    assert codec.dtype == torch.bfloat16
    assert [e["phase"] for e in run["epochs"]] == ["recon", "gan"]
    assert all(np.isfinite(v) for e in run["epochs"] + run["val"] for v in e.values()
               if isinstance(v, float))

    # the JAX bf16 codec loads the checkpoint strictly: fp32 parameters
    jcfg = jload_config("audio_dac", os.path.join(ROOT, "configs"),
                        [*TINY, *BF16, f"codec.checkpoint={run['checkpoint']}",
                         f"data={tmp_path / 'jax' / 'chords'}"])
    jc, template = _jax_template(jcfg)
    assert jc.encoder.dtype == jnp.bfloat16
    flat = jckpt.flatten_tree(jckpt.load_checkpoint(run["checkpoint"])["model_state_dict"])
    assert all(np.asarray(v).dtype == np.float32 for k, v in flat.items()
               if not k.endswith("initted"))
    params = jckpt.load_into_tree(template, flat, strict=True)

    # pre-encoding: the port's files against the root script's on the val split
    enc = pe.main([*common, f"codec.checkpoint={run['checkpoint']}"])
    with pytest.MonkeyPatch.context() as mp:        # the port Loader's batch order
        mp.setattr(jax_datasets, "Loader", functools.partial(jax_datasets.Loader, prefetch=1))
        _root_script().process_dataset(jcfg, "val", jc, params, make_mesh())
    out = enc["val"]["out_dir"]
    jout = os.path.join(f"{tmp_path / 'jax' / 'chords'}_encoded_dac", "val")
    names = sorted(os.path.relpath(os.path.join(r, f), out) for r, _, fs in os.walk(out)
                   for f in fs)
    assert len(names) == 24 and names == sorted(
        os.path.relpath(os.path.join(r, f), jout) for r, _, fs in os.walk(jout) for f in fs)
    ours = np.stack([np.load(os.path.join(out, f)) for f in names])
    ref = np.stack([np.load(os.path.join(jout, f)) for f in names])
    assert ours.dtype == ref.dtype == np.float32 and ours.shape == (24, 8, 8, 8)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-2 * float(np.abs(ref).max()))

    # a bf16 flow with its evaluation on the bf16 codec, then serving as trained
    res = tf.main([*common, f"+output_dir={tmp_path}/flow", "flow.batch_size=32",
                   "flow.epochs=1", "flow.ckpt_every=1", "flow.n_steps=3", "flow.bf16=true"])
    (ev,) = res["eval"]
    assert ev["metrics"]["nfe"] == 8 and all(np.isfinite(v) for v in ev["metrics"].values())
    served = gs.main(["--config-name", "audio_dac", "+device=cpu",
                      f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=4",
                      "+n_steps=3", f"+output_dir={tmp_path}/gen"])
    assert served["bf16"] and served["images"].dtype == np.float32
    assert served["images"].shape == (4, 512, 1) and np.isfinite(served["images"]).all()
    assert len(served["wav_files"]) == 4
    for path in served["wav_files"]:
        with wave.open(path, "rb") as w:
            meta = (w.getsampwidth(), w.getframerate(), w.getnchannels(), w.getnframes())
            pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        assert meta == (2, 16000, 1, 512) and pcm.any()
