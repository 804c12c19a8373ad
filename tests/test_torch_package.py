"""flocoder_torch as a package: it imports nothing of JAX, optax, the JAX
package or the JAX tools (the serving, codec-training, pre-encoding and
flow-training modules, the SD VAE, HDiT and MoE, the host pipeline's shard,
decoder and device augmentation, the audio family, the reflow-pairs tool,
the VQGAN+ codec, the web UI, the quality-runs tool, the parallel
layer's mesh and its ring attention alike) and builds
its native libraries under ``flocoder_torch/build/``, never from
``native/``; its entry point refuses
to run without a card unless asked for the CPU, MIDI export and the options
of the SD-VAE family that are not ported yet refuse (the U-Net in bf16 now
runs), and ``python -m flocoder_torch.generate_samples`` serves end to end
on the CPU from checkpoints in the npz contract."""
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import flocoder_torch
from flocoder_torch import generate_samples as gs
from flocoder_torch.config import load_config
from flocoder_torch.models.codecs import NATTENBlock, setup_codec
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.training.checkpoint import (UNET_PREFIXES, VQVAE_PREFIXES,
                                                save_checkpoint, to_jax_flat)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; torch's default of one
    thread per core oversubscribes them, and its OpenMP pool then stalls
    (a 0.5 s test took 30 s). One thread each keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_every_module_imports_without_jax():
    mods = [m.name for m in pkgutil.walk_packages(flocoder_torch.__path__,
                                                  "flocoder_torch.")]
    assert "flocoder_torch.ops.kernels.na2d" in mods and len(mods) > 25
    for m in ("train_vqgan", "training.vqgan", "models.discriminator",
              "models.perceptual", "ops.rvq", "data.datasets", "data.transforms",
              "utils.codebook_analysis", "metrics", "preencode_data", "ops.fused_vq",
              "ops.kernels.fused_vq", "train_flow", "evaluate_model", "training.flow",
              "training.ema", "training.schedules", "ops.ot", "ops.sinkhorn", "ops.fid",
              "models.sd_vae", "models.hdit", "models.flow_model", "parallel.moe",
              "data.shard", "data.native_image", "data.device_augs", "ops.quant",
              "ops.audio", "data.audio_io", "models.audio_codec", "models.audio_disc",
              "training.audio", "train_audio_codec", "make_reflow_pairs",
              "models.vqgan_plus", "utils.logging", "utils.interactive_scatter",
              "utils.plot_metrics", "utils.profiling", "models.inception", "ui",
              "ui.webapp", "quality_runs", "parallel.mesh", "parallel.ring_attention"):
        assert f"flocoder_torch.{m}" in mods, m
    # the native libraries build and load with the JAX package blocked
    code = ("import sys, importlib\n"
            "for name in ('jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes', 'flocoder_tpu',\n"
            "             'oracles', 'tools'):\n"
            "    sys.modules[name] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from flocoder_torch.data import shard, native_image\n"
            "print(shard.library_file())\n"
            "print(native_image.library_file() if native_image.available() else '')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'ml_dtypes', 'flocoder_tpu', 'oracles', 'tools') and "
            "sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr
    libs = [line for line in res.stdout.splitlines() if line.endswith(".so")]
    assert libs
    build = os.path.realpath(os.path.join(REPO, "flocoder_torch", "build")) + os.sep
    native = os.path.realpath(os.path.join(REPO, "native")) + os.sep
    for lib in libs:
        assert os.path.realpath(lib).startswith(build), lib
        assert not os.path.realpath(lib).startswith(native), lib


def test_no_port_library_path_points_into_native():
    """The port's sources and built libraries live under flocoder_torch/;
    nothing of it names the JAX package's native/ directory as a path."""
    from flocoder_torch.ops.kernels import build
    assert os.path.realpath(build.CSRC_DIR) == os.path.join(REPO, "flocoder_torch", "csrc")
    for src in ("fcloader.cpp", "fcimage.cpp"):
        assert os.path.isfile(os.path.join(build.CSRC_DIR, src))
        path = build.library_path(src, flags=build.GXX_FLAGS)
        assert os.path.dirname(os.path.realpath(path)) == os.path.realpath(build.BUILD_DIR)
    pkg = os.path.join(REPO, "flocoder_torch")
    for root, _, names in os.walk(pkg):
        if os.path.basename(root) in ("build", "__pycache__"):
            continue
        for name in names:
            if name.endswith((".py", ".cpp", ".cu", ".cuh")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert not re.search(r"""["']native["']\s*\)|native/\w""", text), name


def _write_checkpoints(tmp_path, overrides):
    """Seeded random-init flow and codec checkpoints for ``smoke_vqgan``
    (32² images, 8×8×4 latents), written with the port's save_checkpoint."""
    codec_path = str(tmp_path / "vqgan_0.npz")
    cfg = load_config("smoke_vqgan", config_dir=gs.CONFIG_DIR,
                      overrides=[f"codec.checkpoint={codec_path}", *overrides])
    codec = init_params(setup_codec(cfg), torch.Generator().manual_seed(0))
    for m in codec.modules():
        if isinstance(m, NATTENBlock):
            m.gamma.data.fill_(1.0)
    save_checkpoint(to_jax_flat(codec, VQVAE_PREFIXES), 0,
                    ckpt_dir=str(tmp_path), prefix="vqgan_")
    unet = Unet(dim=8, channels=4, n_classes=int(cfg.flow.get("n_classes", 0)))
    init_params(unet, torch.Generator().manual_seed(1))
    return save_checkpoint(to_jax_flat(unet, UNET_PREFIXES), 0,
                           ckpt_dir=str(tmp_path), prefix="flowema_", config=cfg)


def test_entry_point_without_card_raises(tmp_path, monkeypatch):
    flow = _write_checkpoints(tmp_path, [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        gs.main(["--config-name", "smoke_vqgan", f"+flow_checkpoint={flow}",
                 "+n_samples=1", f"+output_dir={tmp_path / 'out'}"])


@pytest.mark.parametrize("overrides,extra", [
    ([], []),
    (["+flow.n_classes=3"], ["+class_cond=1"]),
])
def test_generate_samples_serves_on_cpu(tmp_path, overrides, extra):
    flow = _write_checkpoints(tmp_path, overrides)
    out = tmp_path / "samples"
    res = gs.main(["--config-name", "smoke_vqgan", f"+flow_checkpoint={flow}",
                   "+n_samples=3", "flow.batch_size=2", "+n_steps=3",
                   "+device=cpu", f"+output_dir={out}", *extra])
    assert res["images"].shape == (3, 32, 32, 3)
    assert np.isfinite(res["images"]).all() and res["nfe"] == 8
    assert len(res["batch_seconds"]) == 2
    assert (out / "sample_001_000.png").exists()


def test_midi_export_raises(tmp_path, monkeypatch):
    """A MIDI data path makes ``generate_samples`` export every sample PNG
    to a ``.mid`` file that parses back; ``midi_to_audio`` raises where the
    ``timidity`` program is missing, as the JAX one does."""
    from flocoder_torch.data.midi_io import read_midi
    flow = _write_checkpoints(tmp_path, [])
    res = gs.main(["--config-name", "smoke_vqgan", f"+flow_checkpoint={flow}",
                   "+n_samples=2", "+n_steps=3", "+device=cpu",
                   "data=/data/pop909_midi", f"+output_dir={tmp_path / 'out'}"])
    assert len(res["midi_files"]) == 2
    for path in res["midi_files"]:
        assert path.endswith(".mid") and os.path.exists(path.replace(".mid", "_rect.png"))
        read_midi(path)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="timidity"):
        gs.midi_to_audio(res["midi_files"][0])


@pytest.mark.parametrize("what", ["hdit_pp_stages", "moe_ep", "sd_int8", "unet_bf16"])
def test_unported_options_of_the_sd_family_raise(what, tmp_path):
    """HDiT's pipelined mid level and MoE expert parallelism wait for later
    items of ROADMAP.md. The U-Net in bf16 is ported since: ``flowers_sd``'s
    U-Net builds in bf16 and computes a finite fp32 velocity; and so are the
    SD VAE's int8 convs: ``+codec.quant_encode=int8`` builds W8A8 encoder
    convolutions (those under 32 channels plain) whose encode stays within
    int8's error of the fp32 encode."""
    from flocoder_torch import preencode_data as pe
    from flocoder_torch import train_flow as tf
    from flocoder_torch.models.flow_model import build_flow_model
    hdit = ["flow.arch=hdit", "flow.hdit_widths=[16,32]", "flow.hdit_d_head=8"]
    if what == "unet_bf16":
        cfg = load_config("flowers_sd", gs.CONFIG_DIR, ["+flow.bf16=true"])
        model = init_params(build_flow_model(cfg, 4, 0, dtype=torch.bfloat16, dim=8),
                            torch.Generator().manual_seed(0))
        assert isinstance(model, Unet) and model.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
        with torch.no_grad():
            v = model(torch.randn(2, 8, 8, 4), torch.tensor([10.0, 900.0]), None)
        assert v.dtype == torch.float32 and v.shape == (2, 8, 8, 4)
        assert torch.isfinite(v).all()
        return
    if what == "sd_int8":
        from flocoder_torch.ops.quant import QuantConv
        ov = ["codec.image_size=32"]
        codec = init_params(setup_codec(load_config("flowers_sd", gs.CONFIG_DIR,
                                                    [*ov, "+codec.quant_encode=int8"])),
                            torch.Generator().manual_seed(0))
        plain = init_params(setup_codec(load_config("flowers_sd", gs.CONFIG_DIR, ov)),
                            torch.Generator().manual_seed(0))
        assert isinstance(codec.encoder._Resnet_0.Conv_0, QuantConv)
        assert not isinstance(codec.encoder.Conv_0, QuantConv) or \
            codec.encoder.Conv_0.in_channels < 32                     # conv_in: 3 channels
        assert not any(isinstance(m, QuantConv) for m in codec.decoder.modules())
        x = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            z, ref = codec.encode(x), plain.encode(x)
        assert z.shape == ref.shape == (1, 4, 4, 4)
        assert 0 < float((z - ref).abs().max()) < 0.1 * float(ref.abs().max())
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if what == "hdit_pp_stages":
            cfg = load_config("flowers_hdit", gs.CONFIG_DIR, [*hdit, "+flow.hdit_pp_stages=2"])
            build_flow_model(cfg, 4, 0)
        elif what == "moe_ep":
            tf.main(["--config-name", "flowers_hdit", "+device=cpu", *hdit,
                     "+flow.hdit_moe_experts=[4,0]", "+flow.moe_ep=true",
                     f"data={tmp_path / 'absent'}"])
    assert not (tmp_path / "absent_encoded_sd").exists()
