"""The port's codec-training entry point, ``flocoder_torch.train_vqgan.main``,
on the CPU: one warmup and one GAN epoch on a tiny config over a folder of
seeded random PNGs. The losses are finite, the step times are reported per
phase, and the checkpoint it writes loads strictly into the JAX package's
codec (which then encodes as the port's trained codec does, within 1e-4)
and into the port's ``generate_samples``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models.codecs import setup_codec as jsetup_codec
from flocoder_tpu.training import checkpoint as jckpt
from flocoder_torch import generate_samples as gs
from flocoder_torch import train_vqgan as tv
from flocoder_torch.config import load_config
from flocoder_torch.data.datasets import create_image_loaders
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.training.checkpoint import (UNET_PREFIXES, save_checkpoint,
                                                to_jax_flat)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; one torch thread each
    keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CODEC = ["codec.hidden_channels=16", "codec.internal_dim=8",
         "codec.vq_num_embeddings=8", "codec.batch_size=4", "codec.epochs=2",
         "codec.warmup_epochs=1", "codec.lambda_perc=0.001"]


def _png_folder(root, n=12, size=40):
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            root / f"img_{i:03d}.png")
    return root


def test_train_vqgan_main_trains_and_checkpoints_cross(tmp_path):
    data = _png_folder(tmp_path / "images")
    ckpt_dir = tmp_path / "ckpt"
    overrides = [f"data={data}", *CODEC]
    res = tv.main(["--config-name", "smoke_vqgan", "+device=cpu", "num_workers=1",
                   f"+ckpt_dir={ckpt_dir}", f"+output_dir={tmp_path / 'out'}",
                   *overrides])
    assert res["device"] == "cpu"
    assert [e["phase"] for e in res["epochs"]] == ["warmup", "gan"]
    assert all(np.isfinite(v) for e in res["epochs"] for k, v in e.items()
               if k not in ("epoch", "phase"))
    assert "d_loss" in res["epochs"][1] and "g_loss" in res["epochs"][1]
    assert len(res["step_seconds"]["warmup"]) == 2 == len(res["step_seconds"]["gan"])
    assert res["val"] and np.isfinite(res["val"][0]["total"])
    assert res["checkpoint"] == str(ckpt_dir / "vqgan_2.npz")
    codec = res["state"].codec
    assert bool(codec.vq.initted)

    # the JAX codec loads the checkpoint strictly and encodes alike
    jcfg = jload_config("smoke_vqgan", config_dir="configs", overrides=overrides)
    jc = jsetup_codec(jcfg)
    template = jc.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params = jckpt.load_into_tree(template, jckpt.flatten_tree(
        jckpt.load_checkpoint(res["checkpoint"])["model_state_dict"]), strict=True)
    img = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        ours = codec.encode(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jc.encode(params, jnp.asarray(img))),
                               atol=1e-4)

    # the port's serving entry point loads it strictly
    cfg = load_config("smoke_vqgan", config_dir=gs.CONFIG_DIR,
                      overrides=[*overrides, f"codec.checkpoint={res['checkpoint']}"])
    unet = init_params(Unet(dim=8, channels=4), torch.Generator().manual_seed(1))
    flow = save_checkpoint(to_jax_flat(unet, UNET_PREFIXES), 0, ckpt_dir=str(tmp_path),
                           prefix="flowema_", config=cfg)
    out = gs.main(["--config-name", "smoke_vqgan", f"+flow_checkpoint={flow}",
                   "+n_samples=1", "+n_steps=2", "+device=cpu",
                   f"+output_dir={tmp_path / 'samples'}"])
    assert out["images"].shape == (1, 32, 32, 3) and np.isfinite(out["images"]).all()


def test_loaders_split_and_fall_back_to_synthetic(tmp_path, capsys):
    data = _png_folder(tmp_path / "images", n=20)
    train, val = create_image_loaders(8, 16, str(data), num_workers=1)
    batch = next(iter(train))
    assert batch["target"].shape == (8, 16, 16, 3) and batch["source"] is batch["target"]
    assert batch["target"].min() >= -1 and batch["target"].max() <= 1
    assert len(train) == 2 and val.batch_size == 2
    train, _ = create_image_loaders(4, 16, str(tmp_path / "absent"), num_workers=1)
    assert "synthetic" in capsys.readouterr().out and len(train) == 57
    # is_midi: the piano-roll transforms, which keep [0, 1] (no normalising)
    train, _ = create_image_loaders(4, 16, str(data), is_midi=True, num_workers=1)
    batch = next(iter(train))
    assert batch["target"].shape == (4, 16, 16, 3)
    assert batch["target"].min() >= 0 and batch["target"].max() <= 1


def test_train_vqgan_without_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        tv.main(["--config-name", "smoke_vqgan", f"data={tmp_path}", *CODEC])


def test_train_vqgan_tpu_vqgan_in_bf16(tmp_path):
    """``tpu_vqgan`` as composed (``codec.bf16``, shared real features) at a
    tiny size: the codec, the discriminator and the perceptual net compute
    in bf16 over fp32 parameters, the losses are finite, and the JAX
    package's ``load_checkpoint`` + ``load_into_tree`` read the checkpoint
    strictly into its bf16 codec, NATTEN's gamma as the port's bf16 value."""
    data = _png_folder(tmp_path / "images", n=8)
    overrides = [f"data={data}", "codec.hidden_channels=16", "codec.internal_dim=8",
                 "codec.num_downsamples=2", "codec.vq_num_embeddings=8", "codec.batch_size=4",
                 "codec.epochs=2", "codec.warmup_epochs=1", "codec.image_size=32",
                 "image_size=32"]
    res = tv.main(["--config-name", "tpu_vqgan", "+device=cpu", "num_workers=1", "no_wandb=true",
                   f"+ckpt_dir={tmp_path / 'ckpt'}", f"+output_dir={tmp_path / 'out'}",
                   *overrides])
    state = res["state"]
    assert state.codec.dtype == state.disc.dtype == torch.bfloat16
    assert [e["phase"] for e in res["epochs"]] == ["warmup", "gan"]
    assert all(np.isfinite(v) for e in res["epochs"] + res["val"] for k, v in e.items()
               if k not in ("epoch", "phase"))
    gammas = {n: p for n, p in state.codec.named_parameters() if n.endswith("gamma")}
    assert gammas and all(p.dtype == torch.bfloat16 for p in gammas.values())
    assert all(p.dtype == torch.float32 for n, p in state.codec.named_parameters()
               if n not in gammas)

    jcfg = jload_config("tpu_vqgan", config_dir="configs", overrides=overrides)
    jc = jsetup_codec(jcfg)
    shapes = jax.eval_shape(jc.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    template = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    params = jckpt.load_into_tree(template, jckpt.flatten_tree(
        jckpt.load_checkpoint(res["checkpoint"])["model_state_dict"]), strict=True)
    flat = jckpt.flatten_tree(params)
    for name, p in gammas.items():
        key = name.replace(".", "/").replace("encoder/", "encoder/params/", 1).replace(
            "decoder/", "decoder/params/", 1)
        assert flat[key].dtype == jnp.bfloat16
        assert np.asarray(flat[key], np.float32).tolist() == p.detach().float().tolist()
