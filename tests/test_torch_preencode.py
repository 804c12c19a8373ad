"""The port's pre-encode entry point, ``flocoder_torch.preencode_data``,
against the root ``preencode_data.py`` on the CPU: one folder of 16 seeded
32×32 PNGs in two class subfolders, the same codec weights (saved by the
JAX package as its npz and loaded strictly into the port),
``quantize=true fused_vq=true``, ``augs_per=2``,
the train split, batch 8 (the JAX test mesh has 8 devices). Both write the
same files under the same class folders, each latent within 1e-5 (fp32;
the JAX fused kernel runs interpreted, the port its plain twin), and both
packages' ``PreEncodedDataset`` read the port's files. The port's
item streams are the JAX ``Loader``'s, and its transforms a line-for-line
copy, so the same seed gives the same augmented pixels."""
import functools
import importlib.util
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.data import datasets as jax_datasets
from flocoder_tpu.data.datasets import PreEncodedDataset as JaxPreEncodedDataset
from flocoder_tpu.models.codecs import setup_codec as jsetup_codec
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.parallel.mesh import make_mesh
from flocoder_tpu.training import checkpoint as jckpt
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch import preencode_data as pe
from flocoder_torch.config import load_config
from flocoder_torch.data.datasets import InfiniteDataset, Loader, PreEncodedDataset
from flocoder_torch.data.shard import ShardReader
from flocoder_torch.generate_samples import CONFIG_DIR
from flocoder_torch.models.codecs import setup_codec
from flocoder_torch.models.layers import init_params
from flocoder_torch.training.checkpoint import VQVAE_PREFIXES, to_jax_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = ["image_size=32", "codec.hidden_channels=16", "codec.internal_dim=8",
             "codec.vq_num_embeddings=16", "codec.codebook_levels=2",
             "preencoding.quantize=true", "preencoding.fused_vq=true",
             "preencoding.augs_per=2", "preencoding.batch_size=8",
             "preencoding.num_workers=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; one torch thread each
    keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_script():
    """The root preencode_data.py, imported by file path."""
    name = "fc_script_preencode_data"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(ROOT, "preencode_data.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def _png_folder(root):
    rng = np.random.default_rng(0)
    for cls in ("daisy", "tulip"):
        os.makedirs(os.path.join(root, cls))
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                os.path.join(root, cls, f"img_{i:02d}.png"))
    return root


def _latents(out_dir):
    return {os.path.relpath(os.path.join(r, f), out_dir): np.load(os.path.join(r, f))
            for r, _, fs in os.walk(out_dir) for f in fs if f.endswith(".npy")}


@pytest.fixture(scope="module")
def encoded(tmp_path_factory):
    """Pre-encodes the train split with both packages from one folder of
    images (copied, since the output directory is named after the data
    path); returns (JAX output, port output, port config, port codec)."""
    tmp = tmp_path_factory.mktemp("preencode")
    jax_data = _png_folder(str(tmp / "jaxside" / "imgs"))
    port_data = str(tmp / "portside" / "imgs")
    shutil.copytree(jax_data, port_data)

    jcfg = jload_config("smoke_vqgan", os.path.join(ROOT, "configs"),
                        [f"data={jax_data}", *OVERRIDES])
    cfg = load_config("smoke_vqgan", CONFIG_DIR, [f"data={port_data}", *OVERRIDES])
    # A seeded init of the port's codec (JAX's jitted init of the whole codec
    # takes 13 s here), the codebooks scaled to the encoder's output spread
    # so that the picks spread over the codes; the JAX package writes it as
    # its npz, which the port then loads strictly.
    init = init_params(setup_codec(cfg), torch.Generator().manual_seed(0))
    with torch.no_grad():
        x = torch.from_numpy(np.random.default_rng(1).uniform(
            -1, 1, (4, 32, 32, 3)).astype(np.float32))
        init.vq.codebooks.mul_(float(init.encode(x).std()) / 0.02)
    params = unflatten_tree({k: jnp.asarray(v) for k, v in
                             to_jax_flat(init, VQVAE_PREFIXES).items()})
    params["vq"] = JaxRVQState(**params["vq"])
    ckpt = jckpt.save_checkpoint(params, 0, ckpt_dir=str(tmp / "ckpt"),
                                 prefix="vqgan_")
    codec = jsetup_codec(jcfg)
    # One batch assembler in the JAX Loader: it draws each batch's item
    # generators inside its assembler threads, where two batches' draws
    # could interleave; with one thread they come in batch order, the
    # order in which the port's Loader draws them.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_datasets, "Loader", functools.partial(jax_datasets.Loader,
                                                             prefetch=1))
        _root_script().process_dataset(jcfg, "train", codec, params, make_mesh())

    cfg.codec.checkpoint = ckpt
    port_codec = pe.load_codec(cfg, torch.device("cpu"))
    stats = pe.process_dataset(cfg, "train", port_codec, torch.device("cpu"))
    assert stats["batches"] == 3 and stats["latents"] == 24
    return (os.path.join(f"{jax_data}_encoded_vqgan", "train"), stats["out_dir"],
            cfg, port_codec)


def test_preencode_writes_the_jax_files(encoded):
    jax_out, port_out, _, _ = encoded
    ref, ours = _latents(jax_out), _latents(port_out)
    assert len(ref) == 24 and set(ours) == set(ref)
    assert {os.path.dirname(k) for k in ours} == {"daisy", "tulip"}
    for name, lat in ref.items():
        assert ours[name].shape == (8, 8, 4) and ours[name].dtype == np.float32
        np.testing.assert_allclose(ours[name], lat, atol=1e-5, err_msg=name)


def test_both_packages_read_the_ports_latents(encoded):
    _, port_out, _, _ = encoded
    ours, ref = PreEncodedDataset(port_out), JaxPreEncodedDataset(port_out)
    assert len(ours) == len(ref) == 24 and ours.n_classes == ref.n_classes == 2
    rng = np.random.default_rng(0)
    for i in (0, 11, 23):
        (a, la), (b, lb) = ours.get(i, rng), ref.get(i, rng)
        np.testing.assert_array_equal(a, b)
        assert la == lb and a.shape == (8, 8, 4) and np.isfinite(a).all()


def test_open_split_rebuilds_the_encoded_batches(encoded):
    """open_split with the same config gives the batches process_dataset
    encoded: their fused encodes are the files it wrote."""
    _, port_out, cfg, codec = encoded
    files = {os.path.basename(k): v for k, v in _latents(port_out).items()}
    _, n_batches, batches = pe.open_split(cfg, "train")
    assert n_batches == 3
    with torch.inference_mode():
        for b, batch in enumerate(batches):
            z = codec.encode_quantize_fused(torch.from_numpy(batch["pixels"]))[0]
            for i, lat in enumerate(z.numpy()):
                np.testing.assert_allclose(files.pop(f"b{b:06d}_{i:03d}.npy"), lat,
                                           atol=1e-6)
    assert not files


def test_preencode_refuses_to_overwrite_a_split(encoded):
    _, _, cfg, codec = encoded
    with pytest.raises(SystemExit, match="Refusing to overwrite"):
        pe.process_dataset(cfg, "train", codec, torch.device("cpu"))


@pytest.mark.parametrize("override", [
    "preencoding.device_augs=true", "preencoding.format=shard",
    "+quant=int8", "codec.bf16=true", "codec.choice=dac",
])
def test_unported_options_raise(override, tmp_path):
    """The options still unported raise, naming ROADMAP.md. Device augs,
    the shard format, ``+quant=int8``, ``codec.bf16`` and the DAC audio
    codec are ported since: on the synthetic set each now runs and writes
    its output (the augmented latents of 32² crops; one shard per split
    that reads back every latent; int8: the encoder's convolutions W8A8 and
    its head plain; bf16: a bf16 codec whose latents are written as
    float32; dac: the synthetic chords' folded latents, quantized through
    the RVQ; tests/test_torch_audio_slice.py holds them to the JAX
    script's)."""
    if override == "codec.choice=dac":
        res = pe.main(["--config-name", "smoke_vqgan", "+device=cpu",
                       f"data={tmp_path / 'absent'}", *OVERRIDES, "preencoding.augs_per=1",
                       override, "+codec.strides=[2,4]", "+codec.base_channels=4",
                       "+codec.crop_len=128"])
        codec = res["codec"]
        assert type(codec).__name__ == "DACCodec" and codec.latent_shape(128) == (4, 4, 4)
        cb = codec.vq.codebooks.numpy()
        sums = (cb[0][:, None, :] + cb[1][None, :, :]).reshape(-1, 4)
        for split in ("val", "train"):
            r = res[split]
            assert r["decoder"] == "wav" and r["latents"] == 8 * r["batches"]
            ds = PreEncodedDataset(r["out_dir"])
            lat = np.stack([ds.get(i, None)[0] for i in range(len(ds))])
            assert lat.shape == (r["latents"], 4, 4, 4) and np.isfinite(lat).all()
            gap = np.abs(lat.reshape(-1, 1, 4) - sums[None]).max(-1).min(1)
            assert gap.max() < 1e-5 * max(1.0, float(np.abs(cb).max()))
        return
    if override in ("+quant=int8", "codec.bf16=true"):
        from flocoder_torch.ops.quant import QuantConv
        res = pe.main(["--config-name", "smoke_vqgan", "+device=cpu",
                       f"data={tmp_path / 'absent'}", *OVERRIDES, "preencoding.augs_per=1",
                       "codec.hidden_channels=32", "codec.internal_dim=32", override])
        codec = res["codec"]
        if override == "+quant=int8":
            assert isinstance(codec.encoder.Conv_0, QuantConv)
            assert not isinstance(codec.encoder.Conv_1, QuantConv)
        else:
            assert codec.dtype == torch.bfloat16
        for split in ("val", "train"):
            r = res[split]
            ds = PreEncodedDataset(r["out_dir"])
            lat = np.stack([ds.get(i, None)[0] for i in range(len(ds))])
            assert lat.dtype == np.float32 and lat.shape == (r["latents"], 8, 8, 4)
            assert np.isfinite(lat).all()
        return
    if override.startswith("preencoding."):
        data = str(tmp_path / "absent")
        res = pe.main(["--config-name", "smoke_vqgan", "+device=cpu", f"data={data}",
                       *OVERRIDES, "preencoding.augs_per=1", override])
        for split in ("val", "train"):
            r = res[split]
            assert r["latents"] == 8 * r["batches"]
            if override == "preencoding.format=shard":
                assert r["format"] == "shard" and r["decoder"] == "pil+transforms"
                assert os.listdir(r["out_dir"]) == ["data.fcshard"]
                fields, labels = ShardReader(os.path.join(r["out_dir"], "data.fcshard")
                                             ).gather(np.arange(r["latents"]))
                lat = fields["target"]
                assert labels.min() >= 0 and labels.max() < 4
            else:
                assert r["format"] == "files" and r["decoder"] == pe.host_decoder(
                    load_config("smoke_vqgan", CONFIG_DIR, [override]))[0]
                ds = PreEncodedDataset(r["out_dir"])
                lat = np.stack([ds.get(i, None)[0] for i in range(len(ds))])
            assert lat.shape == (r["latents"], 8, 8, 4) and np.isfinite(lat).all()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pe.main(["--config-name", "smoke_vqgan", "+device=cpu", override])


def test_preencode_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        pe.main(["--config-name", "smoke_vqgan", "data=/nowhere/imgs"])


def test_preencoded_dataset_reads_plain_latents_as_jax_does(tmp_path):
    """.npy, .npz with one 'latents' array and the reference's CHW .pt
    tensors, read by both packages; an inpainting triplet is read as the
    same dict by both."""
    rng = np.random.default_rng(3)
    lat = {c: rng.standard_normal((4, 4, 2)).astype(np.float32) for c in "abc"}
    for c in "abc":
        os.makedirs(tmp_path / c)
    np.save(tmp_path / "a" / "x.npy", lat["a"])
    np.savez(tmp_path / "b" / "x.npz", latents=lat["b"])
    torch.save(torch.from_numpy(lat["c"]).permute(2, 0, 1).contiguous(),
               tmp_path / "c" / "x.pt")
    ours, ref = PreEncodedDataset(str(tmp_path)), JaxPreEncodedDataset(str(tmp_path))
    assert ours.n_classes == ref.n_classes == 3
    g = np.random.default_rng(0)
    for i in range(3):
        (a, la), (b, lb) = ours.get(i, g), ref.get(i, g)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, lat["abc"[i]])
        assert la == lb == i
    np.savez(tmp_path / "a" / "y.npz", target_latents=lat["a"], source_latents=lat["b"],
             mask_pixels=np.ones((16, 16, 1), bool))
    ours, ref = PreEncodedDataset(str(tmp_path)), JaxPreEncodedDataset(str(tmp_path))
    i = ours.files.index(str(tmp_path / "a" / "y.npz"))
    (a, la), (b, lb) = ours.get(i, g), ref.get(i, g)
    assert set(a) == set(b) == {"target_latents", "source_latents", "mask_pixels"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert la == lb == 0


class _Draws:
    """A toy dataset whose item is its index plus draws from its generator,
    so that a batch shows both the order and each item's stream."""
    n_classes = 3

    def __len__(self):
        return 10

    def get(self, i, rng):
        return np.float32(i) + rng.random(2, dtype=np.float32), np.int32(i % 3)


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_streams_match_jax(shuffle):
    """The port's Loader over InfiniteDataset gives the JAX Loader's batches
    (the same order, the same per-item generators), for two epochs."""
    kw = dict(num_workers=2, seed=5, shuffle=shuffle, key="pixels")
    ours = Loader(InfiniteDataset(_Draws(), length=9), 4, **kw)
    ref = jax_datasets.Loader(jax_datasets.InfiniteDataset(_Draws(), length=9), 4,
                              prefetch=1, **kw)
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert set(a) == set(b) == {"pixels", "class_cond"}
            np.testing.assert_array_equal(a["pixels"], b["pixels"])
            np.testing.assert_array_equal(a["class_cond"], b["class_cond"])
