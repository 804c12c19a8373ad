"""VQGAN+ codec training in the port against the JAX package, on the CPU:
one warmup step here, one GAN step in ``test_torch_vqgan_plus_gan.py``, the
entry points in ``test_torch_vqgan_plus_slice.py`` (separate files, so that
the test runner's per-file workers take them in parallel; they import the
helpers here).

- The steps (the GAN step with the full ``VQGANPlusDiscriminator`` and
  LeCAM, weight 0.1, so that its term moves the discriminator's gradient
  well above the tolerance) against the JAX steps on the same weights: the
  codec (hidden 16, two downsamples, 16² images, the RVQ initialised with
  live codes, so no random draw enters the step), the discriminator (base
  16, two layers), the perceptual loss off (the VGG16 net's part is held in
  ``test_torch_vqgan_step.py``), with that file's tolerances: losses and
  updated parameters 1e-4, Adam's first moments of the codec and of the
  discriminator 1e-4 of that model's largest |mu| plus 1e-3 relative.
  Adam's first update moves a weight by ±lr by the sign of its gradient,
  so a weight whose reference moment lies within that moment tolerance of
  zero (its sign is not determined at fp32; one such weight of 2,304 in the
  encoder's first convolution had |mu| 3e-9, 4e-7 of the largest, with
  opposite signs) is held to 1e-4 + 2·lr.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models import discriminator as jdisc
from flocoder_tpu.models import vqgan_plus as jvp
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.training import vqgan as jvqgan
from flocoder_tpu.training.checkpoint import load_into_tree, unflatten_tree
from flocoder_torch.config import load_config
from flocoder_torch.models import discriminator as tdisc
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.vqgan_plus import VQGANPlus
from flocoder_torch.training import vqgan as tvqgan
from flocoder_torch.training.checkpoint import DISC_PREFIXES, VQVAE_PREFIXES, to_jax_flat
from test_torch_vqgan_step import (_assert_grads, _assert_losses, _codec_flat, _images,
                                   _jax_codec_flat, _jax_moments, _moments, _noisy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(hidden_channels=16, num_downsamples=2, internal_dim=8, vq_embedding_dim=4,
          vq_num_embeddings=8, codebook_levels=2, commitment_weight=0.5)
LECAM = 0.1
S = 16


@functools.lru_cache(maxsize=1)
def _plus_base():
    codec = _noisy(init_params(VQGANPlus(**KW), torch.Generator().manual_seed(0)), 1)
    rng = np.random.default_rng(2)
    L, K, D = codec.vq.codebooks.shape
    codec.vq.assign_({
        "codebooks": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32) * 0.5),
        "ema_counts": torch.from_numpy(rng.uniform(4, 30, (L, K)).astype(np.float32)),
        "ema_sums": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "initted": torch.tensor(True)})
    tree = unflatten_tree({k: jnp.asarray(v) for k, v in
                           to_jax_flat(codec, VQVAE_PREFIXES).items()})
    jparams = {"encoder": tree["encoder"], "decoder": tree["decoder"],
               "vq": JaxRVQState(**{k: tree["vq"][k] for k in
                                    ("codebooks", "ema_counts", "ema_sums", "initted")})}
    disc = _noisy(tdisc.init_discriminator(
        tdisc.VQGANPlusDiscriminator(base_channels=16, n_layers=2),
        torch.Generator().manual_seed(3)), 4)
    jd = jdisc.VQGANPlusDiscriminator(base_channels=16, n_layers=2)
    template = jax.jit(functools.partial(jdisc.init_discriminator, jd))(
        jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    jdvars = load_into_tree(template, to_jax_flat(disc, DISC_PREFIXES), strict=True)
    over = ["codec.lambda_perc=0.0", "codec.learning_rate=0.0001"]
    return dict(codec=codec, disc=disc, jcodec=jvp.VQGANPlus(**KW), jparams=jparams, jd=jd,
                jdvars=jdvars, vgg=None, jvgg=None,
                tcfg=load_config("smoke_vqgan", config_dir="configs", overrides=over),
                jcfg=jload_config("smoke_vqgan", config_dir="configs", overrides=over))


def _setup():
    base = _plus_base()
    return dict(base, codec=copy.deepcopy(base["codec"]), disc=copy.deepcopy(base["disc"]))


def _assert_updated(ours: dict, ref: dict, ours_mu: dict, ref_mu: dict, what: str,
                    lr: float):
    """The parameters after one Adam step: 1e-4, or 1e-4 + 2·lr where the
    reference moment is within the moments' tolerance of zero; the moments
    themselves are held by ``_assert_grads``."""
    assert set(ours) == set(ref), what
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref_mu.values())
    for k in ref:
        atol = np.full(np.shape(ref[k]), 1e-4)
        if k in ref_mu:
            atol[np.abs(np.asarray(ref_mu[k])) <= 1e-4 * scale] += 2 * lr
        d = np.abs(np.asarray(ours[k], np.float64) - np.asarray(ref[k], np.float64))
        assert (d <= atol).all(), f"{what}: {k} max |d| {d.max():.3e}"
    _assert_grads(ours_mu, ref_mu, f"{what} gradient")


def test_warmup_step_matches_jax():
    s = _setup()
    x = _images(40)
    tx_g, tx_d = jvqgan.make_vqgan_optimizers(1e-4)
    jstate = jvqgan.create_vqgan_state(s["jparams"], tx_g, s["jdvars"], tx_d)
    jstep = jvqgan.make_vqgan_warmup_step(s["jcodec"], tx_g, s["jcfg"], s["jvgg"],
                                          donate=False)
    jstate, jaux, _ = jax.block_until_ready(
        jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(1)))

    state = tvqgan.create_vqgan_state(s["codec"], s["disc"], 1e-4)
    state, aux, idx = tvqgan.make_vqgan_warmup_step(s["tcfg"], s["vgg"])(
        state, torch.from_numpy(x), torch.Generator())
    assert idx.shape == (2, 4, 4, 2)
    _assert_losses(aux, jaux)
    _assert_updated(_codec_flat(state.codec), _jax_codec_flat(jstate.params),
                    _moments(state.codec, state.opt_g, VQVAE_PREFIXES),
                    _jax_moments(jstate.opt_g, ""), "codec", 1e-4)
