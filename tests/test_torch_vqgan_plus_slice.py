"""The VQGAN+ codec through the port's entry points on the CPU at a tiny
width: ``train_vqgan.main`` with ``codec.choice=vqgan_plus
discriminator=vqgan_plus lecam_weight=0.001`` writes a checkpoint that the
JAX ``VQGANPlus`` loads strictly and encodes with as the port's trained
codec does (1e-4); ``preencode_data.main`` with ``preencoding.fused_vq=true``
takes the unfused RVQ on it and says so (every latent a sum of one code of
each level); ``generate_samples.main`` serves a flow checkpoint whose codec
it is, in fp32 and with ``+quant=int8``.
"""
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models import vqgan_plus as jvp
from flocoder_tpu.models.codecs import setup_codec as jsetup_codec
from flocoder_tpu.training import checkpoint as jckpt
from flocoder_tpu.training.checkpoint import flatten_tree
from flocoder_torch import generate_samples as gs
from flocoder_torch import preencode_data as pe
from flocoder_torch import train_vqgan as tv
from flocoder_torch.config import load_config
from flocoder_torch.models import discriminator as tdisc
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.models.vqgan_plus import VQGANPlus
from flocoder_torch.training.checkpoint import UNET_PREFIXES, save_checkpoint, to_jax_flat
from test_torch_train_vqgan import _png_folder


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CODEC = ["codec.choice=vqgan_plus", "+discriminator=vqgan_plus", "+lecam_weight=0.001",
         "codec.hidden_channels=16", "codec.internal_dim=8", "codec.vq_num_embeddings=8",
         "codec.batch_size=4", "codec.epochs=2", "codec.warmup_epochs=1"]


def test_train_preencode_and_serve_vqgan_plus_on_cpu(tmp_path, capsys):
    data = _png_folder(tmp_path / "images")
    overrides = [f"data={data}", *CODEC]
    res = tv.main(["--config-name", "smoke_vqgan", "+device=cpu", "num_workers=1",
                   f"+ckpt_dir={tmp_path / 'ckpt'}", f"+output_dir={tmp_path / 'out'}",
                   *overrides])
    state = res["state"]
    assert isinstance(state.codec, VQGANPlus)
    assert isinstance(state.disc, tdisc.VQGANPlusDiscriminator)
    assert [e["phase"] for e in res["epochs"]] == ["warmup", "gan"]
    assert all(np.isfinite(v) for e in res["epochs"] for k, v in e.items()
               if k not in ("epoch", "phase"))
    assert "d_loss" in res["epochs"][1]

    # the JAX VQGANPlus loads the checkpoint strictly and encodes alike
    jc = jsetup_codec(jload_config("smoke_vqgan", config_dir="configs", overrides=overrides))
    assert isinstance(jc, jvp.VQGANPlus)
    template = jax.jit(jc.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params = jckpt.load_into_tree(template, flatten_tree(
        jckpt.load_checkpoint(res["checkpoint"])["model_state_dict"]), strict=True)
    img = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ours = state.codec.encode(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax.jit(jc.encode)(params, jnp.asarray(img))),
                               atol=1e-4)

    # pre-encoding with fused_vq=true takes the unfused RVQ, loudly
    ck = f"codec.checkpoint={res['checkpoint']}"
    capsys.readouterr()
    enc = pe.main(["--config-name", "smoke_vqgan", "+device=cpu", ck, *overrides,
                   "preencoding.quantize=true", "preencoding.fused_vq=true",
                   "preencoding.augs_per=2", "preencoding.batch_size=4",
                   "preencoding.num_workers=1"])
    out = capsys.readouterr().out
    assert "quantize: rvq (preencoding.fused_vq=true, but the VQGANPlus codec has no " \
           "fused path)" in out
    assert enc["train"]["quantize"] == enc["val"]["quantize"] == "rvq"
    files = glob.glob(f"{enc['train']['out_dir']}/*/*.npy")
    assert files and len(files) == enc["train"]["latents"]
    cb = enc["codec"].vq.codebooks                 # (2 levels, 8 codes, 4)
    sums = (cb[0][:, None] + cb[1][None]).reshape(-1, 4)
    for f in files[:4]:             # quantized: each token is a code of each level, summed
        z = torch.from_numpy(np.load(f)).reshape(-1, 4)
        assert z.shape == (64, 4) and torch.isfinite(z).all()
        gap = (z[:, None] - sums[None]).abs().amax(dim=2).min(dim=1).values
        assert float(gap.max()) < 1e-5

    # serving through a flow checkpoint whose codec it is, fp32 and int8
    cfg = load_config("smoke_vqgan", config_dir=gs.CONFIG_DIR, overrides=[*overrides, ck])
    unet = init_params(Unet(dim=8, channels=4), torch.Generator().manual_seed(1))
    flow = save_checkpoint(to_jax_flat(unet, UNET_PREFIXES), 0, ckpt_dir=str(tmp_path),
                           prefix="flowema_", config=cfg)
    for quant in ("false", "int8"):
        out = gs.main(["--config-name", "smoke_vqgan", f"+flow_checkpoint={flow}",
                       "+n_samples=2", "+n_steps=2", "+device=cpu", f"+quant={quant}",
                       f"+output_dir={tmp_path / ('samples_' + quant)}"])
        assert out["images"].shape == (2, 32, 32, 3) and np.isfinite(out["images"]).all()
        assert out["quant"] == (quant == "int8")
