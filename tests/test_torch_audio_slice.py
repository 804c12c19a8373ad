"""The audio slice as a whole on the CPU at a tiny size: ``audio_dac.yaml``
with strides (2, 4), base 4, 16 codes, 512-sample crops (8×8×8 latents),
synthetic chords, discriminators with periods 2 and 3 and 2 scales.

The port's ``train_audio_codec`` (one reconstruction epoch, then one GAN
epoch, validation WAVs each epoch) → ``preencode_data`` → ``train_flow``
(one epoch with ``evaluate_model_audio``) → ``generate_samples`` (WAVs
read back through stdlib ``wave``). Each package loads the other's
``dac_`` checkpoint strictly, the port's written uncompressed (its npz
members stored), and the port's pre-encoded latents equal the root
``preencode_data.py``'s ``process_dataset`` on the same checkpoint within
1e-5·max(1, |ref|). Resume loads strictly; rotation keeps the newest 5.
"""
import functools
import importlib.util
import os
import sys
import wave
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.data import datasets as jax_datasets
from flocoder_tpu.models import audio_codec as jac
from flocoder_tpu.models.codecs import setup_codec as jsetup_codec
from flocoder_tpu.parallel.mesh import make_mesh
from flocoder_tpu.training import checkpoint as jckpt
from flocoder_torch import generate_samples as gs
from flocoder_torch import preencode_data as pe
from flocoder_torch import train_audio_codec as tac
from flocoder_torch import train_flow as tf
from flocoder_torch.data.datasets import PreEncodedDataset
from flocoder_torch.models.audio_codec import DACCodec
from flocoder_torch.training import checkpoint as tckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["codec.strides=[2,4]", "codec.base_channels=4", "codec.crop_len=512",
        "codec.vq_num_embeddings=16", "codec.fft_sizes=[64,128,256]", "codec.n_mels=[16,32,64]",
        "codec.disc_periods=[2,3]", "codec.disc_scales=2", "codec.disc_base_channels=4",
        "num_workers=2", "preencoding.num_workers=2", "preencoding.augs_per=1",
        "preencoding.batch_size=8", "no_wandb=true"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_script():
    name = "fc_script_preencode_data"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "preencode_data.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _jax_template(jcfg):
    """The JAX codec's parameter tree (structure from flax's init traced
    abstractly, values zero)."""
    jc = jsetup_codec(jcfg)
    shapes = jax.eval_shape(jc.init, jax.random.PRNGKey(0), jnp.zeros((1, 512, 1)))
    return jc, jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope="module")
def codec_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("audio")
    data = str(tmp / "chords")                      # absent: the synthetic chords
    res = tac.main(["--config-name", "audio_dac", "+device=cpu", f"data={data}", *TINY,
                    f"+ckpt_dir={tmp}/ck", f"+output_dir={tmp}/out", "codec.batch_size=4",
                    "codec.epochs=2", "codec.gan_warmup_epochs=1", "+eval_every=1",
                    "+synthetic_n=16"])
    return dict(tmp=tmp, data=data, res=res)


def _read_wav(path):
    with wave.open(path, "rb") as w:
        meta = (w.getsampwidth(), w.getframerate(), w.getnchannels(), w.getnframes())
        x = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return meta, x


def test_codec_training_recon_then_gan(codec_run):
    res = codec_run["res"]
    assert [e["phase"] for e in res["epochs"]] == ["recon", "gan"]
    assert {"gen", "feat", "d_loss"} <= set(res["epochs"][1]) and all(
        np.isfinite(v) for e in res["epochs"] for v in e.values() if isinstance(v, float))
    assert len(res["step_seconds"]["recon"]) == len(res["step_seconds"]["gan"]) == 4
    assert len(res["val"]) == 2 and len(res["wavs"]) == 8
    for path in res["wavs"]:
        meta, x = _read_wav(path)
        assert meta == (2, 16000, 1, 512) and x.any()
    assert os.path.basename(res["checkpoint"]) == "dac_2.npz"
    state = res["state"]
    assert isinstance(state.codec, DACCodec) and bool(state.codec.vq.initted)


def test_port_checkpoint_loads_into_jax_strictly(codec_run):
    """The checkpoint holds the codec's tree and nothing else (no
    discriminator, no Adam state), its npz members stored; the JAX package
    loads it strictly and reads the port's values."""
    path = codec_run["res"]["checkpoint"]
    with zipfile.ZipFile(path) as z:
        assert {i.compress_type for i in z.infolist()} == {zipfile.ZIP_STORED}
    jcfg = jload_config("audio_dac", os.path.join(ROOT, "configs"), TINY)
    _, template = _jax_template(jcfg)
    ck = jckpt.load_checkpoint(path)
    assert ck["epoch"] == 2 and set(ck) >= {"model_state_dict"}
    assert "optimizer_state_dict" not in ck and "ema_state_dict" not in ck
    params = jckpt.load_into_tree(template, jckpt.flatten_tree(ck["model_state_dict"]),
                                  strict=True)
    ours = tckpt.to_jax_flat(codec_run["res"]["state"].codec, tckpt.DAC_PREFIXES)
    for k, v in jckpt.flatten_tree(params).items():
        assert np.array_equal(np.asarray(v), ours[k]), k


def test_jax_checkpoint_resumes_the_port_strictly(codec_run, tmp_path):
    """A ``dac_`` checkpoint the JAX package wrote (its ``save_checkpoint`` of
    the codec's tree, compressed, as its script writes) resumes the port's
    trainer strictly; a checkpoint with a key too many raises."""
    jcfg = jload_config("audio_dac", os.path.join(ROOT, "configs"), TINY)
    _, template = _jax_template(jcfg)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 0.1 + 0.5).astype(a.dtype), template)
    jpath = jckpt.save_checkpoint(params, 7, ckpt_dir=str(tmp_path / "j"), prefix="dac_")
    argv = ["--config-name", "audio_dac", "+device=cpu", f"data={codec_run['data']}", *TINY,
            f"+ckpt_dir={tmp_path}/ck", f"+output_dir={tmp_path}/out", "codec.batch_size=4",
            "codec.epochs=0", "+synthetic_n=8", "codec.gan=false"]
    res = tac.main([*argv, f"+load_checkpoint={jpath}"])
    ours = tckpt.to_jax_flat(res["state"].codec, tckpt.DAC_PREFIXES)
    for k, v in jckpt.flatten_tree(params).items():
        assert np.array_equal(np.asarray(v), ours[k]), k
    bad = dict(tckpt.load_checkpoint(jpath)["model_state_dict"], **{"vq/extra": np.zeros(1)})
    bpath = tckpt.save_checkpoint(bad, 8, ckpt_dir=str(tmp_path / "b"), prefix="dac_")
    with pytest.raises(KeyError, match="extra"):
        tac.main([*argv, f"+load_checkpoint={bpath}"])


def test_checkpoint_rotation_keeps_the_newest_five(tmp_path):
    flat = tckpt.to_jax_flat(DACCodec(strides=(2,), base_channels=2), tckpt.DAC_PREFIXES)
    for epoch in range(1, 8):
        path = tckpt.save_checkpoint(flat, epoch, ckpt_dir=str(tmp_path), prefix="dac_", keep=5)
        os.utime(path, (epoch, epoch))              # distinct mtimes, in order
    assert sorted(os.listdir(tmp_path)) == [f"dac_{e}.npz" for e in range(3, 8)]
    assert tckpt.load_checkpoint(str(tmp_path / "dac_7.npz"))["epoch"] == 7


def test_preencode_matches_the_jax_script(codec_run, tmp_path):
    """Both packages pre-encode the val split (25 synthetic chords, 3
    batches of 8) with the trained checkpoint: the same folded latents in
    the same files. ``inpainting`` with ``dac`` raises, as in JAX."""
    ckpt = codec_run["res"]["checkpoint"]
    ov = [*TINY, f"codec.checkpoint={ckpt}"]
    jdata, pdata = str(tmp_path / "jax" / "chords"), str(tmp_path / "port" / "chords")
    jcfg = jload_config("audio_dac", os.path.join(ROOT, "configs"), [f"data={jdata}", *ov])
    jc, template = _jax_template(jcfg)
    params = jckpt.load_into_tree(template, jckpt.flatten_tree(
        jckpt.load_checkpoint(ckpt)["model_state_dict"]), strict=True)
    with pytest.MonkeyPatch.context() as mp:        # the port Loader's batch order
        mp.setattr(jax_datasets, "Loader", functools.partial(jax_datasets.Loader, prefetch=1))
        _root_script().process_dataset(jcfg, "val", jc, params, make_mesh())
    res = pe.main(["--config-name", "audio_dac", "+device=cpu", f"data={pdata}", *ov])
    assert res["val"]["latents"] == 24 and res["val"]["decoder"] == "wav"
    assert res["train"]["latents"] == 224
    out, jout = res["val"]["out_dir"], os.path.join(f"{jdata}_encoded_dac", "val")
    names = sorted(os.path.relpath(os.path.join(r, f), out) for r, _, fs in os.walk(out) for f in fs)
    assert len(names) == 24 and names == sorted(
        os.path.relpath(os.path.join(r, f), jout) for r, _, fs in os.walk(jout) for f in fs)
    ours = np.stack([np.load(os.path.join(out, f)) for f in names])
    ref = np.stack([np.load(os.path.join(jout, f)) for f in names])
    assert ours.shape == ref.shape == (24, 8, 8, 8) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * max(1.0, float(np.abs(ref).max())))
    with pytest.raises(SystemExit, match="inpainting"):
        pe.main(["--config-name", "audio_dac", "+device=cpu", f"data={tmp_path / 'other'}",
                 *ov, "+inpainting=true"])


def test_flow_and_serving_write_wavs(codec_run, tmp_path):
    """Pre-encode with the newest ``dac_`` under ``+ckpt_dir`` (the default
    codec), one flow epoch with the audio evaluation, then serving: every
    WAV 16-bit at 16 kHz, 512 frames, finite and not silent."""
    tmp, data = codec_run["tmp"], str(tmp_path / "chords")
    common = ["--config-name", "audio_dac", "+device=cpu", f"data={data}", *TINY,
              f"+ckpt_dir={tmp}/ck"]
    enc = pe.main(common)
    n_train = enc["train"]["latents"]
    assert len(PreEncodedDataset(enc["train"]["out_dir"])) == n_train == 224
    res = tf.main([*common, f"+output_dir={tmp_path}/flow", "flow.batch_size=32",
                   "flow.epochs=1", "flow.ckpt_every=1", "flow.n_steps=3"])
    (ev,) = res["eval"]
    assert set(ev["metrics"]) == {"sinkhorn", "sinkhorn_mel", "mse", "pred_mean", "targ_mean",
                                  "pred_std", "targ_std", "nfe"}
    assert ev["metrics"]["nfe"] == 8 and all(np.isfinite(v) for v in ev["metrics"].values())
    assert set(ev["seconds"]) == {"sampler", "decode", "metrics", "wavs"}
    flow_wavs = sorted(f for f in os.listdir(f"{tmp_path}/flow") if f.endswith(".wav"))
    assert flow_wavs == sorted([f"ep0001_{i}_gen.wav" for i in range(4)] + [
        f"ep0001_{i}_target.wav" for i in range(2)])
    out = gs.main(["--config-name", "audio_dac", "+device=cpu",
                   f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=6", "+n_steps=3",
                   f"+output_dir={tmp_path}/gen"])
    assert out["images"].shape == (6, 512, 1) and len(out["wav_files"]) == 6
    assert not out["midi_files"] and not any(f.endswith(".png") for f in
                                             os.listdir(f"{tmp_path}/gen"))
    for path in out["wav_files"]:
        meta, x = _read_wav(path)
        assert meta == (2, 16000, 1, 512) and x.any()
    # an fp32 flow served in bf16 on request: the U-Net and the DAC codec
    # compute in bf16, and the waveforms are written widened to fp32
    bf16 = gs.main(["--config-name", "audio_dac", "+device=cpu", "+bf16=true",
                    f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=2", "+n_steps=3",
                    f"+output_dir={tmp_path}/gen16"])
    assert bf16["bf16"] and bf16["images"].dtype == np.float32
    assert bf16["images"].shape == (2, 512, 1) and np.isfinite(bf16["images"]).all()
    assert not np.array_equal(bf16["images"], out["images"][:2])
    for path in bf16["wav_files"]:
        meta, x = _read_wav(path)
        assert meta == (2, 16000, 1, 512) and x.any()


def test_entry_point_needs_a_card_or_the_cpu_and_refuses_bf16(monkeypatch, tmp_path):
    """Without ``+device=cpu`` and a card the trainer raises; ``codec.bf16``
    builds the codec in bf16 over fp32 parameters (it raised before the DAC
    in bf16 was ported; ``test_torch_audio_bf16_slice.py`` trains one)."""
    argv = ["--config-name", "audio_dac", f"data={tmp_path / 'x'}", *TINY]
    res = tac.main([*argv, "+device=cpu", "+codec.bf16=true", "codec.epochs=0",
                    "+synthetic_n=8", f"+ckpt_dir={tmp_path}/ck", f"+output_dir={tmp_path}/out"])
    codec = res["state"].codec
    assert codec.dtype == torch.bfloat16 and codec.decoder.Conv_0.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in [*codec.parameters(),
                                                 *res["state"].disc.parameters()])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        tac.main(argv)
    with pytest.raises(SystemExit, match="pre-encoded"):
        tf.main(["--config-name", "audio_dac", "+device=cpu", f"data={tmp_path / 'x'}", *TINY,
                 "flow.pre_encoded=false"])
    assert jac.DACCodec.is_audio and DACCodec.is_audio
