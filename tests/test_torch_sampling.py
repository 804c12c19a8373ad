"""The port's sampler (flocoder_torch.sampling / evaluation) against the JAX
package's. The randomness is injected: both sides get the same ``source``
noise and explicit class ids, never each other's random draws.

Tolerances (absolute, fp32): 1e-6 for the time grid; 1e-5 for the
integrators on an analytic velocity field; 1e-4 for latents and decoded
images of the whole sampler + decode slice on shared weights (RK4, CFG,
4 grid points = 12 U-Net forwards on a doubled batch, then the codec).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu import evaluation as jeval
from flocoder_tpu import sampling as jsamp
from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch import evaluation as teval
from flocoder_torch import sampling as tsamp
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
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


@pytest.mark.parametrize("n_steps,init_strength,warp_s", [
    (20, 0.0, 0.5), (7, 0.0, None), (10, 0.4, 0.5), (5, 0.0, 1.3)])
def test_warp_time_and_time_grid_match_jax(n_steps, init_strength, warp_s):
    ours = tsamp._time_grid(n_steps, init_strength, warp_s).numpy()
    ref = np.asarray(jsamp._time_grid(n_steps, init_strength, warp_s,
                                      jnp.float32))
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    t = np.linspace(0, 1, 11, dtype=np.float32)
    tw, dtw = tsamp.warp_time(torch.from_numpy(t), dt=0.1, s=0.7)
    jtw, jdtw = jsamp.warp_time(jnp.asarray(t), dt=0.1, s=0.7)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jtw), atol=1e-6)
    np.testing.assert_allclose(dtw.numpy(), np.asarray(jdtw), atol=1e-6)


def _field(xp):
    """An analytic velocity field v(x, t, cond) that depends on x, t and the
    class id (0 for the null id −1), written once per framework."""
    def apply_fn(x, t, cond):
        v = -x * (1.0 + t[:, None, None, None] / 999.0)
        if cond is not None and cond.get("class_cond") is not None:
            cc = cond["class_cond"]
            off = xp.where(cc >= 0, cc + 1.0, 0.0 * cc)
            v = v + off[:, None, None, None] * 0.25
        return v
    return apply_fn


@pytest.mark.parametrize("method", ["euler", "rk4", "heun", "midpoint"])
@pytest.mark.parametrize("cfg", [0.0, 3.0])
def test_integrators_and_cfg_velocity_match_jax(method, cfg):
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    init = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    cc = np.array([0, 1, -1], np.int32)
    kw = dict(method=method, n_steps=6, cfg_strength=cfg)
    for init_strength in (0.0, 0.3):
        jinit = jnp.asarray(init) if init_strength else None
        tinit = torch.from_numpy(init) if init_strength else None
        ref, jnfe = jsamp.generate_latents(
            _field(jnp), x0.shape, jax.random.PRNGKey(0),
            cond={"class_cond": jnp.asarray(cc)}, source=jnp.asarray(x0),
            init_latents=jinit, init_strength=init_strength, **kw)
        ours, nfe = tsamp.generate_latents(
            _field(torch), x0.shape, torch.Generator(),
            cond={"class_cond": torch.from_numpy(cc)},
            source=torch.from_numpy(x0), init_latents=tinit,
            init_strength=init_strength, **kw)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
        assert nfe == int(jnfe)
    f = tsamp.cfg_velocity(_field(torch), {"class_cond": torch.from_numpy(cc)}, cfg)
    jf = jsamp.cfg_velocity(_field(jnp), {"class_cond": jnp.asarray(cc)}, cfg)
    np.testing.assert_allclose(f(torch.from_numpy(x0), 0.25).numpy(),
                               np.asarray(jf(jnp.asarray(x0), 0.25)), atol=1e-5)


def test_unported_methods_raise():
    """Every sampling method of the JAX package is ported; an unknown name
    raises."""
    for method in ("rk45", "sde", "ab4", "meanflow"):
        x, nfe = tsamp.generate_latents(_field(torch), (1, 2, 2, 1), torch.Generator(),
                                        method=method, n_steps=6)
        assert x.shape == (1, 2, 2, 1) and nfe > 0
    with pytest.raises(ValueError, match="unknown sampling method"):
        tsamp.generate_latents(_field(torch), (1, 2, 2, 1), torch.Generator(),
                               method="dopri8")


@pytest.mark.parametrize("method,n_steps", [("ab4", 9), ("ab4", 4), ("sde", 7),
                                            ("meanflow", 3), ("meanflow", 1), ("rk45", 0)])
@pytest.mark.parametrize("cfg", [0.0, 3.0])
def test_new_samplers_match_jax(method, n_steps, cfg):
    """AB4 (with its RK4 bootstrap and the short-grid RK4 case), the SDE
    sampler with JAX's noise passed in, MeanFlow segments and adaptive RK45,
    from the same x0, within 1e-4."""
    rng = np.random.default_rng(1)
    x0 = rng.normal(size=(3, 4, 4, 2)).astype(np.float32)
    cc = np.array([0, 1, -1], np.int32)
    key = jax.random.PRNGKey(2)
    ref, jnfe = jsamp.generate_latents(
        _field(jnp), x0.shape, key, method=method, n_steps=n_steps, cfg_strength=cfg,
        cond={"class_cond": jnp.asarray(cc)}, source=jnp.asarray(x0))
    noise = None
    if method == "sde":
        _, k_noise = jax.random.split(key)
        noise = torch.stack([torch.from_numpy(np.asarray(jax.random.normal(k, x0.shape)))
                             for k in jax.random.split(k_noise, n_steps - 1)])
    ours, nfe = tsamp.generate_latents(
        _field(torch), x0.shape, torch.Generator(), method=method, n_steps=n_steps,
        cfg_strength=cfg, cond={"class_cond": torch.from_numpy(cc)},
        source=torch.from_numpy(x0), noise=noise)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    assert nfe == int(jnfe)


def test_meanflow_sampler_on_a_dual_time_unet_matches_jax():
    unet = Unet(dim=8, channels=2, dim_mults=(1, 2), n_classes=3, dual_time=True)
    init_params(unet, torch.Generator().manual_seed(4))
    jparams = _to_jax(unet, UNET_PREFIXES)["model"]
    jm = JaxUnet(dim=8, channels=2, dim_mults=(1, 2), n_classes=3, dual_time=True)
    x0 = np.random.default_rng(5).normal(size=(2, 8, 8, 2)).astype(np.float32)
    cc = np.array([1, 2], np.int32)
    kw = dict(method="meanflow", n_steps=2, cfg_strength=2.0, t_scale=1.0)
    ref, _ = jsamp.generate_latents(lambda x, t, c: jm.apply(jparams, x, t, c), x0.shape,
                                    jax.random.PRNGKey(0), cond={"class_cond": jnp.asarray(cc)},
                                    source=jnp.asarray(x0), **kw)
    with torch.no_grad():
        ours, nfe = tsamp.generate_latents(unet, x0.shape, torch.Generator(),
                                           cond={"class_cond": torch.from_numpy(cc)},
                                           source=torch.from_numpy(x0), **kw)
    assert nfe == 2
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def _to_jax(module, prefixes):
    return unflatten_tree({k: jnp.asarray(v) for k, v in
                           to_jax_flat(module, prefixes).items()})


def test_sampler_and_decode_slice_matches_jax():
    """``evaluation.sampler``: RK4 with CFG over 4 grid points, then the
    VQGAN decode, on a U-Net (dim 8) and a codec (hidden 16, 2 downsamples,
    4×4×4 latents, so NA2D runs at 8×8 with a 7×7 window) sharing weights."""
    unet = Unet(dim=8, channels=4, dim_mults=(1, 2), n_classes=3)
    codec = tcodecs.VQVAE(hidden_channels=16, num_downsamples=2,
                          internal_dim=8, vq_embedding_dim=4,
                          vq_num_embeddings=8, codebook_levels=2)
    init_params(unet, torch.Generator().manual_seed(0))
    init_params(codec, torch.Generator().manual_seed(1))
    with torch.no_grad():   # let the zero-init NATTEN and non-local branches act
        for m in codec.modules():
            if isinstance(m, tcodecs.NATTENBlock):
                m.gamma.fill_(0.7)
            if isinstance(m, tcodecs.SpatialNonLocalAttention):
                m.Conv_3.weight.normal_(0, 0.2, generator=torch.Generator().manual_seed(2))
    jparams = _to_jax(unet, UNET_PREFIXES)["model"]
    jcodec_params = _to_jax(codec, VQVAE_PREFIXES)

    rng = np.random.default_rng(3)
    x0 = rng.normal(size=(2, 4, 4, 4)).astype(np.float32)
    cc = np.array([2, 0], np.int32)
    kw = dict(method="rk4", batch_size=2, n_steps=4, n_classes=3,
              latent_shape=(4, 4, 4), cfg_strength=3.0)
    jm = JaxUnet(dim=8, channels=4, dim_mults=(1, 2), n_classes=3)
    jcodec = jcodecs.VQVAE(hidden_channels=16, num_downsamples=2,
                           internal_dim=8, vq_embedding_dim=4,
                           vq_num_embeddings=8, codebook_levels=2)
    jlat, jimg, jnfe = jeval.sampler(
        lambda x, t, c: jm.apply(jparams, x, t, c), jcodec, jcodec_params,
        jax.random.PRNGKey(0), cond={"class_cond": jnp.asarray(cc)},
        source=jnp.asarray(x0), **kw)
    lat, img, nfe = teval.sampler(
        unet, codec, torch.Generator(), cond={"class_cond": torch.from_numpy(cc)},
        source=torch.from_numpy(x0), **kw)
    assert img.shape == (2, 16, 16, 3) and nfe == int(jnfe) == 12
    np.testing.assert_allclose(lat.numpy(), np.asarray(jlat), atol=1e-4)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-4)


@pytest.mark.parametrize("n_classes", [0, 3])
def test_e2e_sampler_is_sampler_without_the_host_steps(n_classes):
    """``make_e2e_sampler``'s function draws the same noise from the same
    generator as ``sampler`` and returns the same latents and images."""
    codec = tcodecs.SimpleResizeAE(latent_shape=(4, 4, 3), image_size=8)
    cc = torch.tensor([2, 0, 1]) if n_classes else None
    kw = dict(method="rk4", n_steps=5, cfg_strength=2.0, n_classes=n_classes)
    f = teval.make_e2e_sampler(_field(torch), codec, (4, 4, 3), batch_size=3, **kw)
    lat, img = f(torch.Generator().manual_seed(7), cc)
    ref_lat, ref_img, _ = teval.sampler(
        _field(torch), codec, torch.Generator().manual_seed(7), batch_size=3,
        latent_shape=(4, 4, 3), cond={"class_cond": cc} if n_classes else None,
        **kw)
    assert img.shape == (3, 8, 8, 3)
    torch.testing.assert_close(lat, ref_lat, rtol=0, atol=0)
    torch.testing.assert_close(img, ref_img, rtol=0, atol=0)
