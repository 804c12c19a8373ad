"""The port's U-Net and VQGAN codec (flocoder_torch.models) against the JAX
package's modules on shared weights. The port's modules get a seeded init,
then seeded noise on every parameter so that zero-init gates and
projections (NATTEN gamma, the non-local output conv, biases) carry
signal; the weight bridge (flocoder_torch.training.checkpoint) hands the
same numbers to the JAX modules. Inputs come from numpy seeds.

Tolerances (absolute, fp32; the reference runs at
jax_default_matmul_precision=highest): 1e-5 for single blocks, 1e-4 for
the U-Net, the encoder and the decoder (outputs of magnitude up to ~10,
through tens of convolutions and GroupNorms whose variance the two
frameworks compute by different formulas).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.models.unet import pixel_shuffle as jax_pixel_shuffle
from flocoder_tpu.models.unet import pixel_unshuffle as jax_pixel_unshuffle
from flocoder_tpu.models.unet import sinusoidal_embedding as jax_sinusoidal
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.models.unet import pixel_shuffle, pixel_unshuffle, sinusoidal_embedding
from flocoder_torch.training.checkpoint import (UNET_PREFIXES, VQVAE_PREFIXES,
                                                to_jax_flat)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; torch's default of one
    thread per core oversubscribes them, and its OpenMP pool then stalls
    (a 0.5 s test took 30 s). One thread each keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def shared_weights(module, prefixes, seed):
    """Seeded init of ``module`` plus N(0, 0.05²) noise on every parameter;
    returns the same weights as a JAX parameter tree."""
    init_params(module, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(
                0.05 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return unflatten_tree({k: jnp.asarray(v) for k, v in
                           to_jax_flat(module, prefixes).items()})


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("n_classes,dual_time", [(3, False), (0, False), (0, True)])
def test_unet_forward_matches_jax(n_classes, dual_time):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    t = np.array([1.0, 500.0, 998.0], np.float32)
    cc = np.array([0, 2, -1]) if n_classes else None   # -1: CFG null token
    jm = JaxUnet(dim=8, channels=4, dim_mults=(1, 2), n_classes=n_classes,
                 dual_time=dual_time)
    tm = Unet(dim=8, channels=4, dim_mults=(1, 2), n_classes=n_classes,
              dual_time=dual_time)
    params = shared_weights(tm, UNET_PREFIXES, 1)["model"]
    jcond = {"class_cond": jnp.asarray(cc)} if n_classes else None
    tcond = {"class_cond": torch.from_numpy(cc)} if n_classes else None
    if dual_time:
        jcond = {"time_horizon": jnp.asarray(t + 100.0)}
        tcond = {"time_horizon": torch.from_numpy(t + 100.0)}
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                       jcond))
    with torch.no_grad():
        ours = tm(torch.from_numpy(x), torch.from_numpy(t), tcond).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_pixel_shuffle_and_embedding_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 4, 6, 12)).astype(np.float32)
    np.testing.assert_array_equal(
        pixel_shuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(
        pixel_unshuffle(torch.from_numpy(x), 2).numpy(),
        np.asarray(jax_pixel_unshuffle(jnp.asarray(x), 2)))
    t = np.array([0.0, 3.5, 999.0], np.float32)
    np.testing.assert_allclose(
        sinusoidal_embedding(torch.from_numpy(t), 16).numpy(),
        np.asarray(jax_sinusoidal(jnp.asarray(t), 16)), atol=1e-5)


@pytest.mark.parametrize("name,make_jax,make_torch", [
    ("natten", lambda: jcodecs.NATTENBlock(), lambda c: tcodecs.NATTENBlock(c)),
    ("nonlocal", lambda: jcodecs.SpatialNonLocalAttention(),
     lambda c: tcodecs.SpatialNonLocalAttention(c)),
    ("attn", lambda: jcodecs.AttnBlock(), lambda c: tcodecs.AttnBlock(c)),
])
def test_codec_blocks_match_jax(name, make_jax, make_torch):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 16)).astype(np.float32)
    tb = make_torch(16)
    params = shared_weights(tb, {"": "params"}, 4)
    ref = np.asarray(make_jax().apply(params, jnp.asarray(x)))
    with torch.no_grad():
        ours = _nhwc(tb(_nchw(x)))
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def _small_vqvae():
    kw = dict(hidden_channels=16, num_downsamples=2, internal_dim=8,
              vq_embedding_dim=4, vq_num_embeddings=8, codebook_levels=2)
    tc = tcodecs.VQVAE(**kw)
    return jcodecs.VQVAE(**kw), shared_weights(tc, VQVAE_PREFIXES, 5), tc


def test_vqvae_encoder_and_decoder_match_jax():
    """Encoder: NATTEN at 16² (C=16) and 8² (C=32, C=8); decoder: NATTEN at
    16² after the RoPE non-local block and the full-attention block."""
    jc, p, tc = _small_vqvae()
    rng = np.random.default_rng(7)
    img = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    with torch.no_grad():
        enc = tc.encode(torch.from_numpy(img)).numpy()
        dec = tc.decode(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(
        enc, np.asarray(jax.jit(jc.encode)(p, jnp.asarray(img))), atol=1e-4)
    np.testing.assert_allclose(
        dec, np.asarray(jax.jit(jc.decode)(p, jnp.asarray(z))), atol=1e-4)
    assert tc.latent_shape(32) == jc.latent_shape(32)


def test_resize_codec_matches_jax():
    rng = np.random.default_rng(8)
    img = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    jc = jcodecs.SimpleResizeAE(latent_shape=(4, 8, 8), image_size=32)
    tc = tcodecs.SimpleResizeAE(latent_shape=(4, 8, 8), image_size=32)
    z = tc.encode(torch.from_numpy(img))
    np.testing.assert_allclose(z.numpy(), np.asarray(jc.encode({}, jnp.asarray(img))),
                               atol=1e-5)
    np.testing.assert_allclose(tc.decode(z).numpy(),
                               np.asarray(jc.decode({}, jnp.asarray(z.numpy()))),
                               atol=1e-5)


@pytest.mark.parametrize("keep_gray", [False, True])
def test_midi_decode_and_image_grid_match_jax(keep_gray, tmp_path):
    """``g2rgb`` through ``decode_latents(is_midi=True)`` on a 1-channel
    codec, and the PNG grid it is saved as, are the JAX package's (exactly:
    thresholds and byte images)."""
    from flocoder_tpu.metrics import g2rgb as jax_g2rgb
    from flocoder_tpu.utils.viz import save_img_grid as jax_save_grid
    from flocoder_torch.evaluation import decode_latents
    from flocoder_torch.utils.viz import save_img_grid
    from PIL import Image

    rng = np.random.default_rng(9)
    z = rng.uniform(size=(3, 4, 4, 1)).astype(np.float32)
    codec = tcodecs.SimpleResizeAE(latent_shape=(4, 4, 1), image_size=8)
    ours = decode_latents(codec, torch.from_numpy(z), is_midi=True,
                          keep_gray=keep_gray, chunk_size=2).numpy()
    dec = np.asarray(jcodecs.SimpleResizeAE(latent_shape=(4, 4, 1),
                                            image_size=8).decode({}, jnp.asarray(z)))
    ref = np.asarray(jax_g2rgb(jnp.asarray(dec), keep_gray=keep_gray))
    np.testing.assert_array_equal(ours, ref)
    p = save_img_grid(ours, epoch=1, tag="t", output_dir=str(tmp_path / "port"))
    jp = jax_save_grid(ref, epoch=1, tag="t", use_wandb=False,
                       output_dir=str(tmp_path / "jax"))
    np.testing.assert_array_equal(np.asarray(Image.open(p)), np.asarray(Image.open(jp)))
