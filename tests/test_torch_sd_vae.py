"""The port's SD VAE (flocoder_torch.models.sd_vae) against the JAX
package's on shared weights, at channels (32, 32, 64, 64) on 32² images
(4×4×4 latents): the same numpy inputs, the port's seeded weights plus
seeded noise on every parameter (GroupNorm scales and biases included),
handed to the JAX module through the weight bridge. Then the port's
diffusers converter against the JAX converter on one state dict of the
diffusers-shaped torch oracle (tests/oracles/torch_sd_vae.py), the nearest
2× upsample against ``jax.image.resize``, the strict weight load, and the
codec factory.

Tolerances (absolute, fp32; the reference runs at
jax_default_matmul_precision=highest): encode and decode 1e-4·max(1,
|ref|); the converted models' outputs 1e-4; the upsample exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models.sd_vae import SDVAE as JaxSDVAE
from flocoder_tpu.models.sd_vae import convert_sd_vae_state_dict as jax_convert
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch.config import load_config
from flocoder_torch.generate_samples import CONFIG_DIR
from flocoder_torch.models.codecs import setup_codec
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.sd_vae import (SDVAE, convert_sd_vae_state_dict,
                                          load_sd_vae_weights)
from flocoder_torch.training.checkpoint import SDVAE_PREFIXES, to_jax_flat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CH = (32, 32, 64, 64)   # small, GroupNorm(32)-compatible


def _shared(seed=0):
    """The port's SD VAE with seeded weights plus N(0, 0.05²) noise on every
    parameter, and the same weights as a JAX tree."""
    codec = SDVAE(image_size=32, channels=CH, weights_path="")
    codec.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in codec.parameters():
            p.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    params = unflatten_tree({k: jnp.asarray(v) for k, v in
                             to_jax_flat(codec, SDVAE_PREFIXES).items()})
    return codec.eval(), params


def _close(ours, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=rel * max(1.0, float(np.abs(ref).max())))


def test_encode_and_decode_match_jax():
    codec, params = _shared()
    jm = JaxSDVAE(image_size=32, channels=CH, weights_path="")
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    z_ref = jm.encode(params, jnp.asarray(x))
    with torch.no_grad():
        z = codec.encode(torch.from_numpy(x))
    assert tuple(z.shape) == (2, *codec.latent_shape(32)) == (2, 4, 4, 4)
    _close(z.numpy(), z_ref)
    zin = np.random.default_rng(2).normal(size=(2, 4, 4, 4)).astype(np.float32)
    rec_ref = jm.decode(params, jnp.asarray(zin))
    with torch.no_grad():
        rec = codec.decode(torch.from_numpy(zin))
        recon, loss, idx, vq = codec(torch.from_numpy(x))
    assert tuple(rec.shape) == (2, 32, 32, 3)
    _close(rec.numpy(), rec_ref)
    assert recon.shape == (2, 32, 32, 3) and float(loss) == 0.0 and idx is None


def test_converter_matches_the_jax_converter_on_the_oracle():
    """One diffusers-shaped state dict through both converters: the port's
    straight into its modules, the JAX package's into its tree. Nothing is
    dropped and the two models agree."""
    from oracles.torch_sd_vae import AutoencoderKL
    torch.manual_seed(0)
    oracle = AutoencoderKL(channels=CH).eval()
    sd = {k: v.detach().numpy() for k, v in oracle.state_dict().items()}
    converted = convert_sd_vae_state_dict(sd)
    flat = jax_convert(sd)
    codec = SDVAE(image_size=32, channels=CH, weights_path="")
    assert len(converted) == len(sd) == len(flat) == len(codec.state_dict())
    codec.load_state_dict(converted, strict=True)
    params = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    jm = JaxSDVAE(image_size=32, channels=CH, weights_path="")
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 3)).astype(np.float32) * 0.5
    z_ref = np.asarray(jm.encode(params, jnp.asarray(x)))
    with torch.no_grad():
        z = codec.encode(torch.from_numpy(x)).numpy()
        rec = codec.decode(torch.from_numpy(z_ref.copy())).numpy()
        z_oracle = oracle.encode_mean(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(z, z_ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(z, z_oracle.permute(0, 2, 3, 1).numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rec, np.asarray(jm.decode(params, jnp.asarray(z_ref))),
                               rtol=0, atol=1e-4)
    # the bridge's flat tree of the converted port model is the JAX converter's
    ours = to_jax_flat(codec, SDVAE_PREFIXES)
    assert set(ours) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(ours[k], flat[k], err_msg=k)


def test_nearest_upsample_is_jax_resize():
    x = np.random.default_rng(4).normal(size=(2, 5, 3, 7)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, 10, 6, 7), "nearest")
    ours = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                           scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref))


def test_weight_file_loads_strictly(tmp_path):
    codec, _ = _shared(5)
    path = str(tmp_path / "sd_vae.npz")
    np.savez(path, **to_jax_flat(codec, SDVAE_PREFIXES))
    fresh = SDVAE(image_size=32, channels=CH, weights_path=path)
    assert load_sd_vae_weights(fresh, path)
    for (k, a), b in zip(codec.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), k
    assert not load_sd_vae_weights(fresh, str(tmp_path / "absent.npz"))
    flat = to_jax_flat(codec, SDVAE_PREFIXES)
    flat.pop(next(iter(flat)))
    np.savez(path, **flat)
    with pytest.raises(KeyError, match="missing"):   # the JAX function falls back
        load_sd_vae_weights(fresh, path)


def test_setup_codec_builds_the_sd_vae_and_refuses_int8():
    """The factory builds the SD VAE; its int8 flags, refused until the W8A8
    convolutions were ported, now build QuantConv on the flagged side only
    (``test_torch_sd_vae_bf16.py`` holds them against JAX)."""
    from flocoder_torch.ops.quant import QuantConv
    cfg = load_config("flowers_sd", config_dir=CONFIG_DIR)
    codec = setup_codec(cfg)
    assert isinstance(codec, SDVAE) and codec.channels == (128, 256, 512, 512)
    assert codec.latent_shape(128) == (16, 16, 4)
    for key, side in (("quant_decode", "decoder"), ("quant_encode", "encoder")):
        q = setup_codec(load_config("flowers_sd", config_dir=CONFIG_DIR,
                                    overrides=[f"+codec.{key}=int8"]))
        for name in ("encoder", "decoder"):
            has = any(isinstance(m, QuantConv) for m in getattr(q, name).modules())
            assert has == (name == side), (key, name)
    init_params(codec, torch.Generator().manual_seed(0))
    with torch.no_grad():
        z = codec.encode(torch.zeros(1, 16, 16, 3))
    assert tuple(z.shape) == (1, 2, 2, 4) and torch.isfinite(z).all()
