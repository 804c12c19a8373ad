"""One GAN step of the VQGAN+ codec with the full ``VQGANPlusDiscriminator``
and LeCAM in the port against the JAX package's, on the same weights; the
helpers, sizes and tolerances are ``test_torch_vqgan_plus_step.py``'s.
"""
import copy

import jax
import jax.numpy as jnp
import pytest
import torch

from flocoder_tpu.models import discriminator as jdisc
from flocoder_tpu.training import vqgan as jvqgan
from flocoder_tpu.training.checkpoint import flatten_tree
from flocoder_torch.training import vqgan as tvqgan
from flocoder_torch.training.checkpoint import DISC_PREFIXES, VQVAE_PREFIXES, to_jax_flat
from test_torch_vqgan_plus_step import LECAM, _assert_updated, _plus_base, _setup
from test_torch_vqgan_step import (_assert_losses, _codec_flat, _images, _jax_codec_flat,
                                   _jax_moments, _moments)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gan_step_with_lecam_matches_jax():
    s = _setup()
    x = _images(41)
    tx_g, tx_d = jvqgan.make_vqgan_optimizers(1e-4)
    jstate = jvqgan.create_vqgan_state(s["jparams"], tx_g, s["jdvars"], tx_d)
    jstep = jvqgan.make_vqgan_gan_step(
        s["jcodec"], tx_g, s["jd"], jdisc.make_disc_apply(s["jd"], update_stats=True),
        jdisc.make_disc_apply(s["jd"]), tx_d, s["jcfg"], s["jvgg"], donate=False,
        lecam_weight=LECAM)
    jstate, jaux, _ = jax.block_until_ready(
        jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(2)))

    state = tvqgan.create_vqgan_state(s["codec"], s["disc"], 1e-4)
    step = tvqgan.make_vqgan_gan_step(s["tcfg"], s["vgg"], lecam_weight=LECAM)
    state, aux, _ = step(state, torch.from_numpy(x), torch.Generator())
    _assert_losses(aux, jaux)
    _assert_updated(_codec_flat(state.codec), _jax_codec_flat(jstate.params),
                    _moments(state.codec, state.opt_g, VQVAE_PREFIXES),
                    _jax_moments(jstate.opt_g, ""), "codec", 1e-4)
    _assert_updated(to_jax_flat(state.disc, DISC_PREFIXES), flatten_tree(jstate.disc_vars),
                    _moments(state.disc, state.opt_d, DISC_PREFIXES),
                    _jax_moments(jstate.opt_d, "params"), "discriminator", 1e-7)
    # LeCAM is in the discriminator's loss: without it the loss differs
    plain = tvqgan.make_vqgan_gan_step(s["tcfg"], s["vgg"])
    _, aux0, _ = plain(tvqgan.create_vqgan_state(*(copy.deepcopy(_plus_base()[k])
                                                   for k in ("codec", "disc")), 1e-4),
                       torch.from_numpy(x), torch.Generator())
    assert abs(float(aux["d_loss"]) - float(aux0["d_loss"])) > 1e-3
