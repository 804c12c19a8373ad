"""Reflow through the port's entry points on the CPU: pairs from a tiny U-Net
teacher (``make_reflow_pairs``, 8×8×3 resize latents, 4 classes), one epoch
of ``train_flow`` with ``+reflow=true`` and its evaluation on them, and the
reflowed EMA checkpoint served by ``generate_samples`` with Euler at
``n_steps=5`` (4 NFE). The refusals, as the JAX script's (and its test,
``tests/test_e2e_scripts.py``): reflow with meanflow, reflow on inpainting
triplets, reflow on latents without ``source_latents``; and the pairs tool
without a card unless asked for the CPU. The step's paired arithmetic is
held to the JAX step in ``test_torch_flow_step.py``.
"""
import numpy as np
import pytest
import torch

from flocoder_torch import generate_samples as gs
from flocoder_torch import make_reflow_pairs as mrp
from flocoder_torch import train_flow as tf
from flocoder_torch.config import Config
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.ops import fid as tfid
from flocoder_torch.training.checkpoint import UNET_PREFIXES, save_checkpoint, to_jax_flat

UNET_CFG = {"image_size": 8, "no_wandb": True, "n_classes": 4, "dim_mults": [1, 2],
            "codec": {"choice": "resize", "image_size": 8, "latent_shape": [3, 8, 8]}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flow_cfg(data, tmp, **flow):
    return Config({**UNET_CFG, "data": str(data), "device": "cpu", "seed": 0,
                   "ckpt_dir": str(tmp / "ck"), "output_dir": str(tmp / "out"),
                   "flow": {"batch_size": 8, "epochs": 1, "learning_rate": 1e-3,
                            "n_steps": 2, "num_workers": 1, "ckpt_every": 1, **flow}})


@pytest.fixture(scope="module")
def reflowed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reflow_train")
    teacher = init_params(Unet(dim=8, channels=3, dim_mults=(1, 2), n_classes=4),
                          torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(to_jax_flat(teacher, UNET_PREFIXES), 1, ckpt_dir=str(tmp),
                           prefix="flowema_", config=Config(UNET_CFG))
    pairs = mrp.main(["--config-name", "smoke", "+device=cpu", f"+flow_checkpoint={ckpt}",
                      f"+out_dir={tmp / 'pairs'}",
                      "+n_pairs=40", "+batch_size=8", "+n_steps=3", "+val_frac=0.2"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfid, "default_feature_fn",
                   lambda image_size=128: tfid.make_random_projection_features(dim=256))
        res = tf.train_flow(_flow_cfg(pairs["out_dir"], tmp, reflow=True))
    return dict(tmp=tmp, pairs=pairs, res=res)


def test_reflow_trains_an_epoch_on_the_pairs(reflowed):
    pairs, res = reflowed["pairs"], reflowed["res"]
    assert (pairs["train"], pairs["val"]) == (32, 8) and pairs["nfe"] == 8     # RK4, 2 steps
    assert np.isfinite(pairs["pairs_per_s"]) and len(pairs["batch_seconds"]) == 5
    (eps,) = res["epoch_seconds"]
    assert eps["steps"] == 4
    (ep,) = res["epochs"]
    assert np.isfinite(ep["loss"]) and np.isfinite(ep["grad_norm"])
    assert res["ot_rounds"] == [] and "ot_rounds" not in ep          # no OT re-pairing
    (ev,) = res["eval"]
    assert np.isfinite(ev["val_loss"]) and np.isfinite(ev["metrics"]["FID_px"])
    assert res["ema_checkpoint"].endswith("flowema_1.npz")


def test_reflowed_checkpoint_serves_at_4_nfe(reflowed):
    out = gs.generate_samples(Config({
        "flow_checkpoint": reflowed["res"]["ema_checkpoint"], "device": "cpu",
        "method": "euler", "n_steps": 5, "n_samples": 4, "batch_size": 4,
        "output_dir": str(reflowed["tmp"] / "served")}))
    assert out["nfe"] == 4
    assert out["images"].shape == (4, 8, 8, 3) and np.isfinite(out["images"]).all()


def _latents(folder, n=16, triplets=False, source=True):
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        d = folder / split / "0000"
        d.mkdir(parents=True)
        for i in range(n):
            z = rng.standard_normal((8, 8, 3)).astype(np.float32)
            if triplets:
                np.savez(d / f"b{i:06d}.npz", target_latents=z, source_latents=z,
                         mask_pixels=np.zeros((8, 8), bool))
            elif source:
                np.savez(d / f"b{i:06d}.npz", target_latents=z, source_latents=-z)
            else:
                np.save(d / f"b{i:06d}.npy", z)
    return folder


@pytest.mark.parametrize("case", ["meanflow", "triplets", "no_source"])
def test_reflow_refusals(case, tmp_path):
    data = _latents(tmp_path / "data", triplets=case == "triplets",
                    source=case != "no_source")
    flow = {"reflow": True, "meanflow": case == "meanflow"}
    match = "meanflow" if case == "meanflow" else "source_latents and no masks"
    with pytest.raises(SystemExit, match=match):
        tf.train_flow(_flow_cfg(data, tmp_path, **flow))


def test_pairs_tool_without_a_card_raises(reflowed, monkeypatch, tmp_path):
    """Like every entry point of the port, the pairs tool runs on the card
    unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=cpu"):
        mrp.main(["--config-name", "smoke", f"+flow_checkpoint={reflowed['res']['checkpoint']}",
                  f"+out_dir={tmp_path / 'pairs'}"])
