"""The port's flow-training entry point (flocoder_torch.train_flow) end to
end on the CPU: ``configs/smoke.yaml`` (resize codec, synthetic images,
16×16×3 latents, U-Net dim 16 with dim_mults (1, 2), 4 classes, batch 32)
through the port's pre-encode, one epoch of ``train_flow`` with its
evaluation, and ``generate_samples`` from the checkpoint it wrote; then the
checkpoint's contract with the JAX package, resume, the twin of
``evaluate_model.py``, and the refused options.

The evaluation's FID features are the rp features at 256 dimensions here
(``default_feature_fn`` patched): the default rp2048's 2048-wide
Newton–Schulz root costs tens of seconds on one CPU thread, and its
features are held to the JAX package's in ``test_torch_eval_metrics.py``.

Tolerance: the velocity of the JAX U-Net on the port's checkpoint 1e-4.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training.checkpoint import load_checkpoint as jload_checkpoint
from flocoder_tpu.training.checkpoint import flatten_tree, load_into_tree
from flocoder_tpu.training.flow import create_flow_state, make_flow_optimizer
from flocoder_tpu.training.schedules import cosine_warm_restarts_decay
from flocoder_torch import evaluate_model as tev
from flocoder_torch import generate_samples as gs
from flocoder_torch import preencode_data as pe
from flocoder_torch import train_flow as tf
from flocoder_torch.ops import fid as tfid
from flocoder_torch.training.checkpoint import UNET_PREFIXES, load_checkpoint, to_jax_flat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rp256(image_size=128):
    return tfid.make_random_projection_features(dim=256)


def _argv(data, tmp, *extra):
    return ["--config-name", "smoke", "+device=cpu", f"data={data}",
            f"+ckpt_dir={tmp}/ck", f"+output_dir={tmp}/out", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flow")
    data = str(tmp / "smoke_data")             # absent: the synthetic set
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfid, "default_feature_fn", _rp256)
        enc = pe.main(["--config-name", "smoke", "+device=cpu", f"data={data}"])
        hooked = []
        res = tf.main(_argv(data, tmp, "flow.epochs=1", "flow.ckpt_every=1"),
                      step_hook=hooked.append)
    return dict(tmp=tmp, data=data, enc=enc, res=res, hooked=hooked)


def test_smoke_preencode_train_flow_generate(trained, tmp_path):
    enc, res = trained["enc"], trained["res"]
    n_train = enc["train"]["latents"]
    assert enc["val"]["latents"] > 0 and n_train >= 32
    (eps,) = res["epoch_seconds"]
    assert eps["steps"] == n_train // 32 == eps["samples"] // 32
    assert trained["hooked"] == [1] * eps["steps"]       # once a step, with the epoch
    (ep,) = res["epochs"]
    assert np.isfinite(ep["loss"]) and np.isfinite(ep["grad_norm"]) and ep["ot_rounds"] >= 1
    assert len(res["ot_rounds"]) == eps["steps"]
    (ev,) = res["eval"]                         # epoch 1: the raw model only
    assert ev["tag"] == "" and np.isfinite(ev["val_loss"])
    assert set(ev["seconds"]) == {"sampler", "decode", "metrics", "grids"}
    assert ev["metrics"]["FID_feature_backend"] == "rp256"
    assert all(np.isfinite(v) for k, v in ev["metrics"].items() if isinstance(v, float))
    assert os.path.basename(res["checkpoint"]) == "flow_1.npz"
    assert os.path.basename(res["ema_checkpoint"]) == "flowema_1.npz"
    assert "decoded_pred_rk4_28_epoch1.png" in os.listdir(res["output_dir"])

    out = gs.main(["--config-name", "smoke", "+device=cpu",
                   f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=4",
                   "+n_steps=4", f"+output_dir={tmp_path}"])
    assert out["images"].shape == (4, 32, 32, 3) and np.isfinite(out["images"]).all()


@pytest.mark.parametrize("which", ["checkpoint", "ema_checkpoint"])
def test_flow_checkpoint_loads_strictly_into_the_jax_unet(trained, which):
    """The port's flow_* and flowema_* files load into the JAX U-Net with
    strict=True, the optimizer state into optax's tree, and the JAX U-Net
    then gives the port's velocity."""
    res = trained["res"]
    ck = jload_checkpoint(res[which])
    jm = JaxUnet(dim=16, channels=3, dim_mults=(1, 2), n_classes=4)
    x = np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype(np.float32)
    t = np.array([10.0, 500.0, 990.0], np.float32)
    cc = np.array([0, 3, -1], np.int32)
    cond = {"class_cond": jnp.asarray(cc), "mask_cond": None}
    template = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t), cond)
    params = load_into_tree({"model": template}, flatten_tree(ck["model_state_dict"]),
                            strict=True)
    ref = jax.jit(jm.apply)(params["model"], jnp.asarray(x), jnp.asarray(t), cond)
    net = res["state"].model if which == "checkpoint" else res["state"].ema
    with torch.no_grad():
        ours = net(torch.from_numpy(x), torch.from_numpy(t),
                   {"class_cond": torch.from_numpy(cc).long()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    if which == "checkpoint":
        tx = make_flow_optimizer(cosine_warm_restarts_decay(1e-4))
        opt = create_flow_state(params, tx).opt_state
        load_into_tree(opt, flatten_tree(ck["optimizer_state_dict"]), strict=True)
        load_into_tree(params, flatten_tree(ck["ema_state_dict"]), strict=True)


def test_resume_restores_parameters_adam_and_ema(trained):
    res = trained["res"]
    again = tf.main(_argv(trained["data"], trained["tmp"], "flow.epochs=1",
                          f"load_checkpoint={res['checkpoint']}"))
    assert again["epoch_seconds"] == [] and again["state"].step == res["state"].step
    ck = load_checkpoint(res["checkpoint"])
    for name, net in (("model_state_dict", again["state"].model),
                      ("ema_state_dict", again["state"].ema)):
        flat = to_jax_flat(net, UNET_PREFIXES)
        assert all(np.array_equal(flat[k], ck[name][k]) for k in flat), name
    old, new = res["state"], again["state"]
    for p_old, p_new in zip(old.model.parameters(), new.model.parameters()):
        torch.testing.assert_close(new.opt.adam.state[p_new]["exp_avg"],
                                   old.opt.adam.state[p_old]["exp_avg"], rtol=0, atol=0)


def test_evaluate_model_script_twin(trained, tmp_path, monkeypatch):
    monkeypatch.setattr(tfid, "default_feature_fn", _rp256)
    out = tev.main(["--config-name", "smoke", "+device=cpu", f"data={trained['data']}",
                    f"+flow_checkpoint={trained['res']['ema_checkpoint']}",
                    "+n_samples=8", "+n_steps=3", f"+output_dir={tmp_path}"])
    assert out["FID_feature_backend"] == "rp256"
    assert all(np.isfinite(v) for v in out.values() if isinstance(v, float))
    assert any(f.startswith("decoded_pred_rk4") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("override", [
    "flow.fsdp=true", "flow.ring_attention=true",
    # HDiT trains now; its expert and pipeline parallelism do not yet
    pytest.param("flow.arch=hdit +flow.moe_ep=true +flow.hdit_pp_stages=2",
                 id="flow.arch=hdit"),
    "+flow.orbax_checkpoints=true", "+flow.sharded_checkpoints=true",
    "+flow.reflow=true", "+flow.n_model=2", "+flow.bf16=true", "codec.choice=dac"])
def test_unported_options_raise(trained, override, tmp_path):
    """The options still unported raise, naming ROADMAP. The U-Net in bf16
    (``+flow.bf16=true``) is ported since: it now trains an epoch on the
    smoke latents with fp32 parameters, a finite loss and a checkpoint that
    serves with ``+bf16=false``. So is the DAC audio codec: it trains only
    on pre-encoded latents, as the JAX script (``flow.pre_encoded=false``
    exits), and reads them from ``<data>_encoded_dac``, which the image
    smoke data lacks; tests/test_torch_audio_slice.py trains it on audio
    latents. Reflow (``+flow.reflow=true``) trains too, on the pairs of
    ``make_reflow_pairs`` (tests/test_torch_reflow_train.py): on the smoke
    latents, which hold no sources, it exits as the JAX script does. FSDP
    (``flow.fsdp=true``) and sharded checkpoints run since too: in one
    process (the degenerate mesh) the FSDP flag trains the one-device step,
    as the JAX script on one device does, and the sharded checkpoint is one
    ``flow_1.host0.npz`` that the JAX loader reassembles
    (tests/test_torch_parallel_*.py run them on several ranks). So does
    the model axis: ``flow.ring_attention=true`` without a model axis
    (``flow.n_model`` 1) trains the ring-free step, as the JAX script reads
    it, and ``+flow.n_model=2`` needs a world of ranks (tests/
    test_torch_ring_models.py trains the ring on two)."""
    if override == "+flow.n_model=2":
        with pytest.raises(RuntimeError, match="torchrun"):
            tf.main(_argv(trained["data"], tmp_path, "flow.epochs=1", override))
        return
    if override in ("flow.fsdp=true", "+flow.sharded_checkpoints=true",
                    "flow.ring_attention=true"):
        from flocoder_tpu.training.checkpoint import load_checkpoint_sharded
        res = tf.main(_argv(trained["data"], tmp_path, "flow.epochs=1", "flow.ckpt_every=1",
                            "flow.no_eval=true", override))
        (ep,) = res["epochs"]
        assert np.isfinite(ep["loss"]) and res["ranks"] == 1 and not res["fsdp"]
        assert not res["ring"] and res["model_axis"] == 1
        if override == "+flow.sharded_checkpoints=true":
            assert os.path.basename(res["checkpoint"]) == "flow_1.host0.npz"
            assert res["ema_checkpoint"] is None
            ck = load_checkpoint_sharded(os.path.dirname(res["checkpoint"]), "flow_", 1)
            assert set(ck["state"]) == {"params", "opt_state", "ema"} and ck["epoch"] == 1
        return
    if override == "+flow.reflow=true":
        with pytest.raises(SystemExit, match="source_latents"):
            tf.main(_argv(f"{trained['data']}_encoded_resize", tmp_path, "flow.epochs=1",
                          override))
        return
    if override == "codec.choice=dac":
        with pytest.raises(SystemExit, match="pre-encoded"):
            tf.main(_argv(trained["data"], tmp_path, "flow.epochs=1", override,
                          "flow.pre_encoded=false"))
        with pytest.raises(FileNotFoundError, match="smoke_data_encoded_dac"):
            tf.main(_argv(trained["data"], tmp_path, "flow.epochs=1", override,
                          "+codec.strides=[2,4]", "+codec.base_channels=4"))
        return
    if override == "+flow.bf16=true":
        res = tf.main(_argv(trained["data"], tmp_path, "flow.epochs=1", "flow.ckpt_every=1",
                            "flow.no_eval=true", override))
        model = res["state"].model
        assert model.dtype == torch.bfloat16
        assert all(p.dtype == torch.float32 for p in model.parameters())
        (ep,) = res["epochs"]
        assert np.isfinite(ep["loss"]) and np.isfinite(ep["grad_norm"])
        out = gs.main(["--config-name", "smoke", "+device=cpu", "+bf16=false",
                       f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=2",
                       "+n_steps=3", f"+output_dir={tmp_path / 'gen'}"])
        assert np.isfinite(out["images"]).all()
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.main(_argv(trained["data"], trained["tmp"], "flow.epochs=1", *override.split()))


def test_inpainting_latents_raise(tmp_path):
    """Inpainting triplets train (tests/test_torch_midi_slice.py), but not
    with MeanFlow: as the JAX script, the port refuses that pairing before
    building a model."""
    for split in ("train", "val"):
        d = tmp_path / "inp_encoded_resize" / split / "0000"
        os.makedirs(d)
        np.savez(d / "a.npz", target_latents=np.zeros((16, 16, 3), np.float32),
                 source_latents=np.zeros((16, 16, 3), np.float32),
                 mask_pixels=np.ones((32, 32, 1), bool))
    with pytest.raises(SystemExit, match="inpainting"):
        tf.main(_argv(tmp_path / "inp", tmp_path, "flow.epochs=1", "flow.batch_size=1",
                      "+flow.meanflow=true"))


def test_train_flow_without_card_raises(trained, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tf.main, tev.main):
        with pytest.raises(RuntimeError, match="device=cpu"):
            main(["--config-name", "smoke", f"data={trained['data']}"])


def test_on_the_fly_encoding_with_grad_accum(tmp_path):
    """``flow.pre_encoded=false``: the frozen codec encodes each image batch
    in the step; with ``flow.grad_accum=2`` each step takes two
    microbatches of 16."""
    res = tf.main(_argv(tmp_path / "absent", tmp_path, "flow.epochs=1", "flow.no_eval=true",
                        "+flow.pre_encoded=false", "+flow.grad_accum=2"))
    (ep,) = res["epochs"]
    assert res["epoch_seconds"][0]["steps"] == 7 and np.isfinite(ep["loss"])
    assert res["eval"] == []
    assert res["state"].step == 7
