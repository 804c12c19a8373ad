"""The SD-VAE latent family as a whole. First an HDiT checkpoint that the
JAX package writes (``flowers_hdit`` at tiny widths with the recipe's NA
variant: patch 1 on 4×4×4 latents, ``na:3`` outer, global inner, 3
classes) is served by both packages with the same x0 and class ids, RK4 +
CFG over 4 grid points, then decoded by an SD VAE at channels (32, 32, 64,
64) with shared weights: the latents agree within 1e-4, the images within
1e-4·max(1, |ref|) (the decoder alone agrees within 1e-5; it carries the
latents' differences to the images with a gain of a few).
Then the port's entry points on the CPU (``+device=cpu``): pre-encoding
``flowers_sd`` (the full-width SD VAE on 32² images), training
``flowers_hdit`` in bf16 with MoE at the outer level for one epoch with its
evaluation, resuming from its checkpoint, and serving the EMA checkpoint
through the SD VAE as trained (bf16) and with ``+bf16=false``; each
finishes with finite outputs. The evaluation's FID features are the rp features at 256
dimensions, as in ``test_torch_train_flow.py``.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flocoder_tpu import evaluation as jeval
from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models import hdit as jh
from flocoder_tpu.models.sd_vae import SDVAE as JaxSDVAE
from flocoder_tpu.training.checkpoint import flatten_tree, unflatten_tree
from flocoder_tpu.training.checkpoint import save_checkpoint as jsave_checkpoint
from flocoder_torch import evaluation as teval
from flocoder_torch import generate_samples as gs
from flocoder_torch import preencode_data as pe
from flocoder_torch import train_flow as tf
from flocoder_torch.config import Config
from flocoder_torch.models.hdit import HDiT
from flocoder_torch.models.sd_vae import SDVAE
from flocoder_torch.ops import fid as tfid
from flocoder_torch.training.checkpoint import SDVAE_PREFIXES, to_jax_flat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = ["flow.hdit_depths=[1,1]", "flow.hdit_widths=[16,32]", "flow.hdit_d_ffs=[32,64]",
        "flow.hdit_d_head=8", "flow.hdit_mapping_depth=1", "flow.hdit_mapping_width=32",
        "flow.hdit_mapping_d_ff=64", "flow.hdit_patch_size=1",
        "flow.hdit_attns=[na:3,global]", "flow.unet.n_classes=3", "codec.image_size=32",
        "no_wandb=true"]
CH = (32, 32, 64, 64)


def test_jax_hdit_checkpoint_serves_alike(tmp_path):
    jcfg = jload_config("flowers_hdit", config_dir=gs.CONFIG_DIR, overrides=TINY)
    jm = jh.hdit_from_config(jcfg, channels=4, n_classes=3, dtype=jnp.float32)
    v0 = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 4)), jnp.zeros((1,)),
                          {"class_cond": jnp.zeros((1,), jnp.int32), "mask_cond": None})
    rng = np.random.default_rng(0)      # every zero-init projection gets signal
    params = unflatten_tree({k: jnp.asarray(v + 0.1 * rng.normal(size=v.shape)
                                            .astype(np.float32))
                             for k, v in flatten_tree(v0["params"]).items()})
    path = jsave_checkpoint({"model": {"params": params}}, 0, ckpt_dir=str(tmp_path),
                            prefix="flowema_", config=jcfg)

    # the recipe says bf16; serving runs in fp32, as +bf16=false asks
    bundle = gs.load_models_once(Config({"bf16": False}), path, torch.device("cpu"))
    assert isinstance(bundle["model"], HDiT) and bundle["latent_shape"] == (4, 4, 4)
    codec = SDVAE(image_size=32, channels=CH, weights_path="")
    codec.init(torch.Generator().manual_seed(1))
    with torch.no_grad():
        for p in codec.parameters():
            p.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    jcodec_params = unflatten_tree({k: jnp.asarray(v) for k, v in
                                    to_jax_flat(codec, SDVAE_PREFIXES).items()})
    x0 = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    cc = np.array([2, 0], np.int32)
    kw = dict(method="rk4", batch_size=2, n_steps=4, n_classes=3, latent_shape=(4, 4, 4),
              cfg_strength=3.0)
    jlat, jimg, jnfe = jeval.sampler(
        lambda x, t, c: jm.apply({"params": params}, x, t, c),
        JaxSDVAE(image_size=32, channels=CH, weights_path=""), jcodec_params,
        jax.random.PRNGKey(0), cond={"class_cond": jnp.asarray(cc)}, source=jnp.asarray(x0),
        **kw)
    lat, img, nfe = teval.sampler(bundle["model"], codec.eval(), torch.Generator(),
                                  cond={"class_cond": torch.from_numpy(cc).long()},
                                  source=torch.from_numpy(x0), **kw)
    assert img.shape == (2, 32, 32, 3) and nfe == int(jnfe) == 12
    assert float(np.abs(np.asarray(jlat) - x0).max()) > 0.1       # the field moved x0
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), rtol=0, atol=1e-4)
    # images of magnitude ~3.5: the decoder carries the latents' error with gain
    jimg = np.asarray(jimg)
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(jimg).max())))


def _pngs(folder, n=10, size=40):
    rng = np.random.default_rng(7)
    for i in range(n):
        sub = os.path.join(folder, "ab"[i % 2])
        os.makedirs(sub, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(sub, f"img_{i}.png"))
    return folder


def test_sd_preencode_hdit_train_and_serve_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tfid, "default_feature_fn",
                        lambda image_size=128: tfid.make_random_projection_features(dim=256))
    data = _pngs(str(tmp_path / "imgs"))
    enc = pe.main(["--config-name", "flowers_sd", "+device=cpu", f"data={data}",
                   "codec.image_size=32", "preencoding.batch_size=4",
                   "preencoding.augs_per=2", "preencoding.num_workers=2"])
    assert enc["val"]["latents"] == 2 and enc["train"]["latents"] == 16
    assert isinstance(enc["codec"], SDVAE)
    files = glob.glob(os.path.join(enc["train"]["out_dir"], "*", "*.npy"))
    assert len(files) == 16
    for f in files:
        lat = np.load(f)
        assert lat.shape == (4, 4, 4) and np.isfinite(lat).all()

    argv = ["--config-name", "flowers_hdit", "+device=cpu", f"data={data}", *TINY,
            "flow.bf16=true", "+flow.hdit_moe_experts=[4,0]", "flow.batch_size=8",
            "flow.epochs=1", "flow.ckpt_every=1", "flow.n_steps=2",
            f"+ckpt_dir={tmp_path}/ck", f"+output_dir={tmp_path}/out"]
    res = tf.main(argv)
    (ep,) = res["epochs"]
    assert res["epoch_seconds"][0]["steps"] == 2
    assert np.isfinite(ep["loss"]) and ep["loss_model_aux"] > 0
    assert ep["loss"] == pytest.approx(ep["loss_flow"] + ep["loss_model_aux"], rel=1e-5)
    (ev,) = res["eval"]
    assert all(np.isfinite(v) for v in ev["metrics"].values() if isinstance(v, float))
    model = res["state"].model
    assert isinstance(model, HDiT) and model.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())

    again = tf.main(argv + [f"load_checkpoint={res['checkpoint']}"])
    assert again["epoch_seconds"] == [] and again["state"].step == res["state"].step
    for p_old, p_new in zip(res["state"].model.parameters(), again["state"].model.parameters()):
        assert torch.equal(p_old, p_new)
        torch.testing.assert_close(again["state"].opt.adam.state[p_new]["exp_avg"],
                                   res["state"].opt.adam.state[p_old]["exp_avg"], rtol=0, atol=0)

    serve = ["--config-name", "flowers_hdit", "+device=cpu",
             f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=2", "+n_steps=2",
             f"+output_dir={tmp_path}/samples"]
    # served as trained: the checkpoint's flow.bf16 serves in bf16 (the SD
    # VAE too), and +bf16=false in fp32
    out = gs.main(serve)
    assert out["bf16"] and out["images"].shape == (2, 32, 32, 3)
    assert np.isfinite(out["images"]).all()
    out = gs.main(serve + ["+bf16=false"])
    assert out["images"].shape == (2, 32, 32, 3) and np.isfinite(out["images"]).all()
