"""The host pipeline as a whole, through the port's entry points on the CPU
(``+device=cpu``) at ``smoke_vqgan``'s size (32² images, 8×8×4 latents)
over a folder of 12 seeded 48² PNGs in two classes:

- pre-encoding with ``fused_vq``, ``device_augs`` (the C++ decoder where it
  builds) and ``format=shard``, then ``train_flow`` on the shards (the
  U-Net in bf16) with its evaluation, then ``evaluate_model`` on the val
  shard: each ends with finite outputs;
- the same pre-encode in files format and in shard format, with
  ``device_augs`` off, writes the same latents with the same labels, in
  the same order (exactly: both encode the same batches);
- an inpainting triplet shard (``inpainting=true``, masks drawn after the
  device augment) trains one epoch with mask conditioning;
- the JAX package's ``ShardReader`` reads the port's shards exactly.
The evaluations' FID features are the rp features at 256 dimensions, as in
``test_torch_train_flow.py``.
"""
import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

from flocoder_torch import evaluate_model as tev
from flocoder_torch import preencode_data as pe
from flocoder_torch import train_flow as tf
from flocoder_torch.data.datasets import PreEncodedDataset
from flocoder_torch.data.shard import ShardReader
from flocoder_torch.ops import fid as tfid
from flocoder_tpu.data import shard as js


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _rp256(monkeypatch):
    monkeypatch.setattr(tfid, "default_feature_fn",
                        lambda image_size=128: tfid.make_random_projection_features(dim=256))


PE = ["--config-name", "smoke_vqgan", "+device=cpu", "preencoding.quantize=true",
      "preencoding.fused_vq=true", "preencoding.augs_per=4", "preencoding.batch_size=8",
      "preencoding.num_workers=2"]


def _pngs(folder, n=12, size=48):
    rng = np.random.default_rng(7)
    for i in range(n):
        sub = os.path.join(folder, "ab"[i % 2])
        os.makedirs(sub, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            os.path.join(sub, f"img_{i}.png"))
    return folder


def _train(data, tmp, *extra):
    return tf.main(["--config-name", "smoke_vqgan", "+device=cpu", f"data={data}",
                    "flow.batch_size=8", "flow.epochs=1", "flow.ckpt_every=1",
                    "flow.n_steps=3", f"+ckpt_dir={tmp}/ck", f"+output_dir={tmp}/out", *extra])


def test_device_augs_shard_train_and_evaluate(tmp_path):
    data = _pngs(str(tmp_path / "imgs"))
    enc = pe.main([*PE, f"data={data}", "preencoding.device_augs=true",
                   "preencoding.format=shard"])
    for split, n in (("val", 4), ("train", 40)):
        r = enc[split]
        assert r["format"] == "shard" and r["decoder"] in ("native", "pil")
        assert r["latents"] == n and os.listdir(r["out_dir"]) == ["data.fcshard"]
        fields, labels = ShardReader(os.path.join(r["out_dir"], "data.fcshard")).gather(
            np.arange(n))
        assert fields["target"].shape == (n, 8, 8, 4) and np.isfinite(fields["target"]).all()
        assert set(labels.tolist()) <= {0, 1}
        # the JAX reader reads the port's file exactly
        jfields, jlabels = js.ShardReader(os.path.join(r["out_dir"], "data.fcshard"),
                                          use_native=False).gather(np.arange(n))
        np.testing.assert_array_equal(jfields["target"], fields["target"])
        np.testing.assert_array_equal(jlabels, labels)

    res = _train(data, tmp_path, "flow.bf16=true")
    (ep,) = res["epochs"]
    assert res["epoch_seconds"][0]["steps"] == 5 and np.isfinite(ep["loss"])
    (ev,) = res["eval"]
    assert all(np.isfinite(v) for v in ev["metrics"].values() if isinstance(v, float))
    metrics = tev.main(["--config-name", "smoke_vqgan", "+device=cpu", f"data={data}",
                        f"+flow_checkpoint={res['ema_checkpoint']}", "+bf16=false",
                        "+n_samples=4", "+n_steps=3", f"+output_dir={tmp_path / 'ev'}"])
    assert metrics["FID_feature_backend"] == "rp256"
    assert all(np.isfinite(v) for v in metrics.values() if isinstance(v, float))


def test_files_and_shard_write_the_same_latents(tmp_path):
    out = {}
    for fmt in ("files", "shard"):
        data = _pngs(str(tmp_path / fmt / "imgs"))
        enc = pe.main([*PE, f"data={data}", f"preencoding.format={fmt}",
                       "preencoding.augs_per=2"])
        r = enc["train"]
        if fmt == "shard":
            fields, labels = ShardReader(os.path.join(r["out_dir"], "data.fcshard")).gather(
                np.arange(r["latents"]))
            out[fmt] = fields["target"], labels
        else:
            ds = PreEncodedDataset(r["out_dir"])
            # b{batch}_{item} names in write order; labels from the class folders
            order = sorted(range(len(ds)), key=lambda i: os.path.basename(ds.files[i]))
            items = [ds.get(i, None) for i in order]
            out[fmt] = (np.stack([x for x, _ in items]),
                        np.array([lab for _, lab in items], np.int32))
    np.testing.assert_array_equal(out["shard"][0], out["files"][0])
    np.testing.assert_array_equal(out["shard"][1], out["files"][1])
    assert out["shard"][0].shape == (16, 8, 8, 4)


def test_inpainting_triplet_shard_trains(tmp_path):
    data = _pngs(str(tmp_path / "imgs"))
    enc = pe.main([*PE, f"data={data}", "+inpainting=true", "preencoding.device_augs=true",
                   "preencoding.format=shard", "preencoding.augs_per=2"])
    r = enc["train"]
    reader = ShardReader(os.path.join(r["out_dir"], "data.fcshard"))
    assert reader.extra_fields == {"source_latents": (8, 8, 4), "mask_pixels": (32, 32, 1)}
    fields, _ = reader.gather(np.arange(r["latents"]))
    assert set(np.unique(fields["mask_pixels"])) <= {0.0, 1.0}
    assert np.isfinite(fields["source_latents"]).all()
    res = _train(f"{data}_encoded_vqgan_inpainting", tmp_path, "flow.no_eval=true")
    (ep,) = res["epochs"]
    assert res["state"].mask_encoder is not None and np.isfinite(ep["loss"])
    assert glob.glob(os.path.join(str(tmp_path), "ck", "flowema_1.npz"))


def test_tpu_demo_as_composed_at_a_tiny_size(tmp_path):
    """``tpu_demo`` (the resize codec with 4 latent channels from RGB
    images, the synthetic set, device augs, shards, the U-Net in bf16) at
    32² images and 8×8×4 latents: the resize codec's ``in_channels`` is its
    latent width, as in the JAX package, so RGB images pre-encode (the
    fourth channel the mean of the three, as the JAX codec gives it), and
    the flow trains an epoch on the shards."""
    import jax.numpy as jnp
    from flocoder_tpu.models.codecs import SimpleResizeAE as JaxResize
    data = str(tmp_path / "fc_tpu_demo")                 # absent: the synthetic set
    tiny = ["codec.image_size=32", "codec.latent_shape=[4,8,8]"]
    enc = pe.main(["--config-name", "tpu_demo", "+device=cpu", f"data={data}", *tiny,
                   "preencoding.augs_per=1", "preencoding.batch_size=32",
                   "preencoding.num_workers=2"])
    r = enc["train"]
    assert r["format"] == "shard" and r["decoder"] in ("native", "pil") and r["latents"] == 224
    lat = ShardReader(os.path.join(r["out_dir"], "data.fcshard")).gather(np.arange(8))[0]["target"]
    np.testing.assert_allclose(lat[..., 3], lat[..., :3].mean(-1), rtol=0, atol=1e-6)
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    from flocoder_torch.models.codecs import SimpleResizeAE
    ours = SimpleResizeAE(latent_shape=(4, 8, 8), image_size=32).encode(torch.from_numpy(x))
    ref = JaxResize(latent_shape=(4, 8, 8), image_size=32).encode({}, jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    res = tf.main(["--config-name", "tpu_demo", "+device=cpu", f"data={data}", *tiny,
                   "flow.batch_size=32", "flow.epochs=1", "flow.no_eval=true",
                   "flow.ckpt_every=1", f"+ckpt_dir={tmp_path}/ck",
                   f"+output_dir={tmp_path}/out"])
    assert res["state"].model.dtype == torch.bfloat16
    assert res["epoch_seconds"][0]["steps"] == 7 and np.isfinite(res["epochs"][0]["loss"])
