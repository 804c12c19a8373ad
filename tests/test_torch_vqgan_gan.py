"""One GAN step (discriminator step, then generator step against the
updated discriminator) of the port's codec training against the JAX
package's on the same weights; the helpers, sizes and tolerances are
``test_torch_vqgan_step.py``'s.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from flocoder_tpu.models import discriminator as jdisc
from flocoder_tpu.training import vqgan as jvqgan
from flocoder_tpu.training.checkpoint import flatten_tree
from flocoder_torch.training import vqgan as tvqgan
from flocoder_torch.training.checkpoint import DISC_PREFIXES, VQVAE_PREFIXES, to_jax_flat
from test_torch_vqgan_step import (_assert_grads, _assert_losses, _assert_tree, _codec_flat,
                                   _images, _jax_codec_flat, _jax_moments, _moments, _setup)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gan_step_matches_jax():
    s = _setup()
    x = _images(30)
    tx_g, tx_d = jvqgan.make_vqgan_optimizers(1e-4)
    jstate = jvqgan.create_vqgan_state(s["jparams"], tx_g, s["jdvars"], tx_d)
    jstep = jvqgan.make_vqgan_gan_step(
        s["jcodec"], tx_g, s["jd"], jdisc.make_disc_apply(s["jd"], update_stats=True),
        jdisc.make_disc_apply(s["jd"]), tx_d, s["jcfg"], s["jvgg"], donate=False)
    jstate, jaux, _ = jax.block_until_ready(
        jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(2)))

    state = tvqgan.create_vqgan_state(s["codec"], s["disc"], 1e-4)
    step = tvqgan.make_vqgan_gan_step(s["tcfg"], s["vgg"], deterministic=True)
    state, aux, _ = step(state, torch.from_numpy(x), torch.Generator())
    _assert_losses(aux, jaux)
    _assert_tree(_codec_flat(state.codec), _jax_codec_flat(jstate.params), "codec")
    _assert_tree(to_jax_flat(state.disc, DISC_PREFIXES), flatten_tree(jstate.disc_vars),
                 "discriminator")
    _assert_grads(_moments(state.codec, state.opt_g, VQVAE_PREFIXES),
                  _jax_moments(jstate.opt_g, ""), "codec gradient")
    _assert_grads(_moments(state.disc, state.opt_d, DISC_PREFIXES),
                  _jax_moments(jstate.opt_d, "params"), "discriminator gradient")
    assert all(p.requires_grad for p in state.disc.parameters())
