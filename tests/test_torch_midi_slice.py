"""The MIDI + inpainting slice of the port at smoke widths, against the JAX
package where both run: a seeded MIDI corpus (the port's
``write_synthetic_corpus``) converted to 128² piano rolls, pre-encoded with
``inpainting=true`` on ``midi_vqgan`` (hidden 16, 64² crops, 8×8×4
latents, seeded random codec weights saved by the JAX package) by both the
root ``preencode_data.py`` and the port, quantized through the fused RVQ
(``preencoding.quantize=true fused_vq=true``, as the pre-encode test of the
image recipes runs it, and as ``midi_inpainting`` pre-encodes): the same
triplet files, the latents within 1e-5 (fp32), the masks exactly. Then the port's
``train_flow`` on its triplets for one epoch (mask-conditioned U-Net, mask
encoder, OTF curriculum, an inpainting evaluation), its checkpoint loaded
strictly into the JAX package's parameter and optimizer trees, and the
port's ``generate_samples`` from the EMA: every ``.mid`` parses, and the
root script's export of the same decoded image writes the same bytes.
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

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.data import datasets as jax_datasets
from flocoder_tpu.inpainting import MaskEncoder as JaxMaskEncoder
from flocoder_tpu.models.codecs import setup_codec as jsetup_codec
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.parallel.mesh import make_mesh
from flocoder_tpu.training import checkpoint as jckpt
from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch import generate_samples as gs
from flocoder_torch import preencode_data as pe
from flocoder_torch import train_flow as tf
from flocoder_torch.config import load_config
from flocoder_torch.data.datasets import MIDIImageDataset
from flocoder_torch.data.midi_io import read_midi, write_synthetic_corpus
from flocoder_torch.models.codecs import setup_codec
from flocoder_torch.models.layers import init_params
from flocoder_torch.ops import fid as tfid
from flocoder_torch.training.checkpoint import VQVAE_PREFIXES, to_jax_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODEC = ["image_size=64", "codec.image_size=64", "codec.hidden_channels=16",
         "codec.internal_dim=8", "codec.vq_num_embeddings=16", "codec.codebook_levels=2",
         "no_wandb=true"]
PRE = ["+inpainting=true", "preencoding.augs_per=2", "preencoding.batch_size=8",
       "preencoding.num_workers=2", "+preencoding.quantize=true", "+preencoding.fused_vq=true"]
FLOW = ["flow.dim_mults=[1,2]", "flow.batch_size=8", "flow.epochs=1", "flow.ckpt_every=1",
        "flow.n_steps=3", "flow.otf_aug=true", "+flow.curriculum_epochs=1",
        "+flow.extend_epochs=2", "+flow.p_ones=0.25", "+flow.p_zeros=0.25",
        "num_workers=2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _root_script(name):
    mod_name = f"fc_script_{name}"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod_name,
                                                      os.path.join(ROOT, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def _triplets(out_dir):
    out = {}
    for r, _, fs in os.walk(out_dir):
        for f in fs:
            with np.load(os.path.join(r, f)) as z:
                out[os.path.relpath(os.path.join(r, f), out_dir)] = {k: z[k] for k in z.files}
    return out


def _rp256(image_size=128):
    return tfid.make_random_projection_features(256, seed=0)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("midi_slice")
    write_synthetic_corpus(str(tmp / "midi"), 6, seed=3)
    MIDIImageDataset(str(tmp / "midi"), str(tmp / "jaxside" / "midi_images"), num_workers=2)
    jax_data = str(tmp / "jaxside" / "midi_images")
    port_data = str(tmp / "portside" / "midi_images")
    shutil.copytree(jax_data, port_data)

    cfg = load_config("midi_vqgan", gs.CONFIG_DIR, [f"data={port_data}", *CODEC, *PRE])
    jcfg = jload_config("midi_vqgan", os.path.join(ROOT, "configs"),
                        [f"data={jax_data}", *CODEC, *PRE])
    # seeded codec weights, the codebooks scaled to the encoder's output
    # spread so that the picks spread over the codes (as tests/test_torch_preencode.py)
    init = init_params(setup_codec(cfg), torch.Generator().manual_seed(0))
    with torch.no_grad():
        x = torch.from_numpy(np.random.default_rng(1).uniform(
            0, 1, (4, 64, 64, 3)).astype(np.float32))
        init.vq.codebooks.mul_(float(init.encode(x).std()) / 0.02)
    params = unflatten_tree({k: jnp.asarray(v) for k, v in
                             to_jax_flat(init, VQVAE_PREFIXES).items()})
    from flocoder_tpu.ops.rvq import RVQState
    params["vq"] = RVQState(**params["vq"])
    ckpt = jckpt.save_checkpoint(params, 0, ckpt_dir=str(tmp / "ckpt"), prefix="vqgan_")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_datasets, "Loader", functools.partial(jax_datasets.Loader,
                                                             prefetch=1))
        _root_script("preencode_data").process_dataset(
            jcfg, "train", jsetup_codec(jcfg), params, make_mesh())
    cfg.codec.checkpoint = ckpt
    codec = pe.load_codec(cfg, torch.device("cpu"))
    stats = {s: pe.process_dataset(cfg, s, codec, torch.device("cpu"))
             for s in ("val", "train")}
    flow_argv = ["--config-name", "midi_vqgan", "+device=cpu",
                 f"data={port_data}_encoded_vqgan_inpainting", f"codec.checkpoint={ckpt}",
                 *CODEC, *FLOW, f"+ckpt_dir={tmp}/ck", f"+output_dir={tmp}/out"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfid, "default_feature_fn", _rp256)
        res = tf.main(flow_argv)
    samples = gs.main(["--config-name", "midi_vqgan", "+device=cpu",
                       f"+flow_checkpoint={res['ema_checkpoint']}", "+n_samples=2",
                       "+n_steps=3", f"+output_dir={tmp}/samples"])
    return dict(tmp=tmp, jax_out=os.path.join(f"{jax_data}_encoded_vqgan_inpainting", "train"),
                stats=stats, res=res, samples=samples)


def test_preencode_writes_the_jax_triplets(slice_run):
    ref = _triplets(slice_run["jax_out"])
    ours = _triplets(slice_run["stats"]["train"]["out_dir"])
    assert len(ref) == slice_run["stats"]["train"]["latents"] == 32 and set(ours) == set(ref)
    n_masked = 0
    for name, r in ref.items():
        o = ours[name]
        assert set(o) == {"target_latents", "source_latents", "mask_pixels"}
        assert o["mask_pixels"].dtype == bool and o["mask_pixels"].shape == (64, 64, 1)
        np.testing.assert_array_equal(o["mask_pixels"], r["mask_pixels"])
        for k in ("target_latents", "source_latents"):
            assert o[k].shape == (8, 8, 4)
            np.testing.assert_allclose(o[k], r[k], atol=1e-5, err_msg=f"{name} {k}")
        n_masked += bool(o["mask_pixels"].any())
    assert n_masked > 0


def test_train_flow_trains_evaluates_and_checkpoints_inpainting(slice_run):
    res = slice_run["res"]
    (ep,) = res["epochs"]
    assert all(np.isfinite(ep[k]) for k in ("loss", "loss_flow", "loss_mask", "grad_norm"))
    (ev,) = res["eval"]
    assert np.isfinite(ev["val_loss"]) and np.isfinite(ev["metrics"]["FID_px"])
    files = os.listdir(res["output_dir"])
    for grid in ("mask_latents", "mask_pixels", "decoded_source", "decoded_pred"):
        assert any(f.startswith(grid) for f in files), grid
    state = res["state"]
    assert state.mask_encoder is not None and state.mask_encoder.target_hw == (8, 8)
    # the checkpoint loads strictly into the JAX package's trees
    ck = jckpt.load_checkpoint(res["checkpoint"])
    ju = JaxUnet(dim=8, channels=4, dim_mults=(1, 2), mask_cond=True, mask_channels=4)
    jm = JaxMaskEncoder(output_channels=4, target_hw=(8, 8))
    shapes = {
        "model": jax.eval_shape(lambda: ju.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                                                jnp.zeros((1,)),
                                                {"class_cond": None,
                                                 "mask_cond": jnp.zeros((1, 8, 8, 4))})),
        "mask_encoder": jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                                       jnp.zeros((1, 64, 64, 1))))}
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    flat = jckpt.flatten_tree
    jckpt.load_into_tree(template, flat(ck["model_state_dict"]), strict=True)
    jckpt.load_into_tree(template, flat(ck["ema_state_dict"]), strict=True)
    tx = jflow.make_flow_optimizer(lambda count: 1e-4, mask_encoder=True)   # a schedule
    jckpt.load_into_tree(tx.init(template), flat(ck["optimizer_state_dict"]), strict=True)


def test_generate_samples_exports_the_jax_midi(slice_run, tmp_path):
    out = slice_run["samples"]
    assert out["images"].shape == (2, 64, 64, 3) and len(out["midi_files"]) == 2
    for path in out["midi_files"]:
        read_midi(path)
    # the root script's export of the same decoded images
    _root_script("generate_samples").save_sample_batch(out["images"], 0, str(tmp_path),
                                                       is_midi=True)
    for path in out["midi_files"]:
        name = os.path.basename(path)
        with open(path, "rb") as a, open(tmp_path / name, "rb") as b:
            assert a.read() == b.read(), name
