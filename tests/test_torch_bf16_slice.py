"""The bf16 and int8 slice as a whole, on ``tpu_vqgan`` (``codec.bf16:
true``) at a tiny size (hidden 32, internal 32, two downsamples, 16 codes
of 2 levels, 32² images, 8×8×4 latents; the U-Net at dim 8), on the CPU.

- Pre-encoding: the port's ``preencode_data`` (``+device=cpu``) and the
  root ``preencode_data.py`` encode the same 16 PNGs with the same bf16
  codec (the same seeded weights, saved as the JAX package's npz), in files
  and in a shard. The latents agree within 3e-2 of the largest |ref| (the
  JAX script encodes under ``jit``, the port op by op: bf16 roundings
  apart; the codecs' own test holds them op by op). The reference's fault
  shows: its ``.npy`` files of bf16 latents have the descr ``<V2`` (an
  opaque two-byte void that its own loader cannot widen), the port's are
  float32, the same values widened exactly. The fused path with ``+quant=int8``
  runs through K3's plain twin on the bf16 activations.
- Serving (``test_torch_bf16_serving.py`` holds the bf16 and int8 cases):
  a ``flow.bf16=true`` checkpoint served with ``+bf16=false`` runs in fp32
  and agrees with the JAX serving path at fp32 (the U-Net and the codec
  built at the serving dtype, as the JAX script's ``load_models_once``
  builds them) from the same injected x0, RK4 over 4 grid points, within
  1e-4·max(1, |ref|).
"""
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

from flocoder_tpu import evaluation as jeval
from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.data import datasets as jax_datasets
from flocoder_tpu.data.shard import ShardReader as JaxShardReader
from flocoder_tpu.models.codecs import setup_codec as jsetup_codec
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.parallel.mesh import make_mesh
from flocoder_tpu.training import checkpoint as jckpt
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch import evaluation as teval
from flocoder_torch import generate_samples as gs
from flocoder_torch import preencode_data as pe
from flocoder_torch.config import Config, load_config
from flocoder_torch.data.datasets import PreEncodedDataset
from flocoder_torch.data.shard import ShardReader
from flocoder_torch.models.codecs import VQVAE, setup_codec
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.ops import quant as tquant
from flocoder_torch.training.checkpoint import (UNET_PREFIXES, VQVAE_PREFIXES,
                                                save_checkpoint, to_jax_flat)

from test_torch_codec_bf16 import _jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["image_size=32", "codec.image_size=32", "codec.hidden_channels=32", "codec.internal_dim=32",
        "codec.num_downsamples=2", "codec.vq_num_embeddings=16",
        "codec.codebook_levels=2", "preencoding.augs_per=1", "preencoding.batch_size=8",
        "preencoding.num_workers=2", "flow.unet.n_classes=0", "flow.n_classes=0"]


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


def _pngs(root):
    rng = np.random.default_rng(0)
    for cls in ("daisy", "tulip"):
        os.makedirs(os.path.join(root, cls))
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(
                os.path.join(root, cls, f"img_{i:02d}.png"))
    return root


@pytest.fixture(scope="module")
def codec_ckpt(tmp_path_factory):
    """A seeded fp32 codec (NATTEN gammas 0.5, codebooks at the latents'
    spread), saved by the JAX package as its npz; returns (path, flat)."""
    tmp = tmp_path_factory.mktemp("codec")
    cfg = load_config("tpu_vqgan", gs.CONFIG_DIR, TINY)
    codec = init_params(setup_codec(cfg, dtype=torch.float32), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for name, p in codec.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.5)
        x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
        codec.vq.codebooks.mul_(float(codec.encode(x).std()) / 0.02)
    flat = to_jax_flat(codec, VQVAE_PREFIXES)
    params = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    params["vq"] = JaxRVQState(**params["vq"])
    return jckpt.save_checkpoint(params, 0, ckpt_dir=str(tmp), prefix="vqgan_"), flat


def _jax_codec(jcfg, flat, dtype=None):
    """The JAX codec of ``jcfg`` (at ``dtype``, or the config's) and the
    flat weights restored into its parameter dtypes (bf16 gammas)."""
    jc = jsetup_codec(jcfg, dtype=dtype)
    template = jax.eval_shape(jc.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params = _jax_params({"encoder": template["encoder"], "decoder": template["decoder"]},
                         {k: v for k, v in flat.items() if not k.startswith("vq/")})
    params["vq"] = JaxRVQState(**{k.split("/")[1]: jnp.asarray(v) for k, v in flat.items()
                                  if k.startswith("vq/")})
    return jc, params


def _read_jax_npy(path):
    """A latent the JAX script saved: float32, or bf16 as ``<V2`` bytes."""
    a = np.load(path)
    if a.dtype.kind == "V":
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


@pytest.mark.parametrize("fmt", ["files", "shard"])
def test_bf16_preencode_matches_the_jax_script(fmt, codec_ckpt, tmp_path):
    ckpt, flat = codec_ckpt
    jdata = _pngs(str(tmp_path / "jax" / "imgs"))
    pdata = str(tmp_path / "port" / "imgs")
    shutil.copytree(jdata, pdata)
    ov = [*TINY, f"preencoding.format={fmt}", f"codec.checkpoint={ckpt}"]
    jcfg = jload_config("tpu_vqgan", os.path.join(ROOT, "configs"), [f"data={jdata}", *ov])
    jc, params = _jax_codec(jcfg, flat)
    with pytest.MonkeyPatch.context() as mp:       # the port Loader's batch order
        mp.setattr(jax_datasets, "Loader", functools.partial(jax_datasets.Loader, prefetch=1))
        _root_script().process_dataset(jcfg, "train", jc, params, make_mesh())
    res = pe.main(["--config-name", "tpu_vqgan", "+device=cpu", f"data={pdata}", *ov])
    assert isinstance(res["codec"], VQVAE) and res["codec"].dtype == torch.bfloat16
    out = res["train"]["out_dir"]
    jout = os.path.join(f"{jdata}_encoded_vqgan", "train")
    if fmt == "shard":
        n = res["train"]["latents"]
        ours = ShardReader(os.path.join(out, "data.fcshard")).gather(np.arange(n))[0]["target"]
        ref = JaxShardReader(os.path.join(jout, "data.fcshard"), use_native=False).gather(
            np.arange(n))[0]["target"]
        assert ours.dtype == ref.dtype == np.float32
    else:
        names = sorted(os.path.relpath(os.path.join(r, f), out)
                       for r, _, fs in os.walk(out) for f in fs)
        assert len(names) == 8 and names == sorted(
            os.path.relpath(os.path.join(r, f), jout) for r, _, fs in os.walk(jout) for f in fs)
        for f in names:                                 # the reference's fault
            with open(os.path.join(jout, f), "rb") as fh:
                assert b"'descr': '<V2'" in fh.read(128), f
            with pytest.raises((ValueError, TypeError)):
                np.load(os.path.join(jout, f)).astype(np.float32)
        ours = np.stack([np.load(os.path.join(out, f)) for f in names])
        ref = np.stack([_read_jax_npy(os.path.join(jout, f)) for f in names])
        assert ours.dtype == np.float32
        # the port's float32 files hold bf16 values, widened exactly
        assert np.array_equal(ours, ours.astype(jnp.bfloat16).astype(np.float32))
        ds = PreEncodedDataset(out)
        assert ds.get(0, None)[0].dtype == np.float32
    assert ours.shape == ref.shape == (8, 8, 8, 4) and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=3e-2 * float(np.abs(ref).max()))


def test_fused_int8_preencode_runs_on_the_cpu(codec_ckpt, tmp_path):
    """``preencoding.fused_vq=true +quant=int8`` on the bf16 codec: the
    encoder's convolutions run W8A8 (the CPU twin), K3's twin takes the bf16
    activations, and every latent is a sum of one code per level."""
    ckpt, flat = codec_ckpt
    data = _pngs(str(tmp_path / "imgs"))
    res = pe.main(["--config-name", "tpu_vqgan", "+device=cpu", f"data={data}", *TINY,
                   "preencoding.quantize=true", "preencoding.fused_vq=true",
                   "preencoding.format=shard", "+quant=int8", f"codec.checkpoint={ckpt}"])
    codec = res["codec"]
    assert isinstance(codec.encoder.Conv_0, tquant.QuantConv)
    n = res["train"]["latents"]
    lat = ShardReader(os.path.join(res["train"]["out_dir"], "data.fcshard")).gather(
        np.arange(n))[0]["target"].reshape(-1, 4)
    cb = flat["vq/codebooks"]
    sums = (cb[0][:, None, :] + cb[1][None, :, :]).reshape(-1, 4)
    gap = np.abs(lat[:, None, :] - sums[None]).max(-1).min(1)
    assert np.isfinite(lat).all() and gap.max() < 1e-2 * float(np.abs(cb).max())


def flow_ckpt(tmp, codec_path):
    """A U-Net checkpoint of a ``flow.bf16=true`` run on ``tpu_vqgan`` (dim
    8, every parameter perturbed so that no layer is zero), its codec at
    ``codec_path``; returns (path, its flat weights)."""
    cfg = load_config("tpu_vqgan", gs.CONFIG_DIR, [*TINY, f"codec.checkpoint={codec_path}",
                                                   "flow.bf16=true"])
    unet = init_params(Unet(dim=8, channels=4), torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    flat = to_jax_flat(unet, UNET_PREFIXES)
    return save_checkpoint(flat, 0, ckpt_dir=str(tmp), prefix="flowema_", config=cfg), flat


def jax_serving(codec_path, codec_flat, unet_flat, dtype, quant=False):
    """The JAX serving path's U-Net and codec at ``dtype`` (with W8A8
    decoder convolutions for ``quant``), as the JAX script builds them:
    ``(unet apply, codec, codec params)``."""
    jcfg = jload_config("tpu_vqgan", os.path.join(ROOT, "configs"),
                        [*TINY, f"codec.checkpoint={codec_path}", "flow.bf16=true",
                         *(["+codec.quant_decode=int8"] if quant else [])])
    jc, jcp = _jax_codec(jcfg, codec_flat, dtype=dtype)
    jm = JaxUnet(dim=8, channels=4, n_classes=0, dtype=dtype)
    jparams = unflatten_tree({k: jnp.asarray(v) for k, v in unet_flat.items()})["model"]
    return (lambda x, t, c: jm.apply(jparams, x, t, c)), jc, jcp


X0 = np.random.default_rng(4).normal(size=(2, 8, 8, 4)).astype(np.float32)
SAMPLER = dict(method="rk4", batch_size=2, n_steps=4, latent_shape=(8, 8, 4), cfg_strength=3.0)


def test_plus_bf16_false_serves_in_fp32(codec_ckpt, tmp_path):
    codec_path, codec_flat = codec_ckpt
    path, unet_flat = flow_ckpt(tmp_path, codec_path)
    b = gs.load_models_once(Config({"bf16": False}), path, torch.device("cpu"))
    assert (b["bf16"], b["quant"]) == (False, False)
    assert b["model"].dtype == b["codec"].dtype == torch.float32
    apply, jc, jcp = jax_serving(codec_path, codec_flat, unet_flat, jnp.float32)
    jlat, jimg = jax.jit(lambda x0: jeval.sampler(apply, jc, jcp, jax.random.PRNGKey(0),
                                                     source=x0, **SAMPLER)[:2])(X0)
    lat, img, nfe = teval.sampler(b["model"], b["codec"], torch.Generator(),
                                  source=torch.from_numpy(X0), **SAMPLER)
    assert nfe == 12 and img.shape == (2, 32, 32, 3) and img.dtype == torch.float32
    for ours, ref in ((lat, jlat), (img, jimg)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(ref).max())))
    out = gs.main(["--config-name", "tpu_vqgan", "+device=cpu", f"+flow_checkpoint={path}",
                   "+n_samples=2", "+n_steps=3", "+bf16=false",
                   f"+output_dir={tmp_path / 'out'}"])
    assert np.isfinite(out["images"]).all() and (out["bf16"], out["quant"]) == (False, False)
