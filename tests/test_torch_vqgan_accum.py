"""Microbatched codec training (``grad_accum=2``) of the port against the
JAX package's on the same weights: the warmup step, whose RVQ state chains
through the microbatches, and the GAN step's simultaneous update (every
microbatch's generator loss against the discriminator before the update,
its power iterations advancing; in ``test_torch_vqgan_gan_accum.py``, so
that the test runner's per-file workers take the two in parallel). The
helpers, sizes and tolerances are ``test_torch_vqgan_step.py``'s. The
perceptual loss is left out here (its parity is held in the single-batch
steps): VGG16 under the JAX microbatch scan costs most of a minute to
compile on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
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


def check_grad_accum_step(phase: str):
    """One ``grad_accum=2`` step of ``phase`` ('warmup' or 'gan') on both
    sides: losses, picks, codec (and discriminator) parameters and first
    moments; a batch that does not divide raises."""
    s = _setup()
    x = _images(40, b=4)
    tx_g, tx_d = jvqgan.make_vqgan_optimizers(1e-4)
    if phase == "warmup":
        jstate = jvqgan.create_vqgan_state(s["jparams"], tx_g)
        jstep = jvqgan.make_vqgan_warmup_step(s["jcodec"], tx_g, s["jcfg"], None,
                                              donate=False, grad_accum=2)
        state = tvqgan.create_vqgan_state(s["codec"], None, 1e-4)
        step = tvqgan.make_vqgan_warmup_step(s["tcfg"], None, deterministic=True,
                                             grad_accum=2)
    else:
        jstate = jvqgan.create_vqgan_state(s["jparams"], tx_g, s["jdvars"], tx_d)
        jstep = jvqgan.make_vqgan_gan_step(
            s["jcodec"], tx_g, s["jd"], jdisc.make_disc_apply(s["jd"], update_stats=True),
            jdisc.make_disc_apply(s["jd"]), tx_d, s["jcfg"], None, donate=False,
            grad_accum=2)
        state = tvqgan.create_vqgan_state(s["codec"], s["disc"], 1e-4)
        step = tvqgan.make_vqgan_gan_step(s["tcfg"], None, deterministic=True,
                                          grad_accum=2)
    jstate, jaux, jidx = jax.block_until_ready(
        jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(3)))
    state, aux, idx = step(state, torch.from_numpy(x), torch.Generator())
    _assert_losses(aux, jaux)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _assert_tree(_codec_flat(state.codec), _jax_codec_flat(jstate.params), "codec")
    _assert_grads(_moments(state.codec, state.opt_g, VQVAE_PREFIXES),
                  _jax_moments(jstate.opt_g, ""), "codec gradient")
    if phase == "gan":
        _assert_tree(to_jax_flat(state.disc, DISC_PREFIXES), flatten_tree(jstate.disc_vars),
                     "discriminator")
        _assert_grads(_moments(state.disc, state.opt_d, DISC_PREFIXES),
                      _jax_moments(jstate.opt_d, "params"), "discriminator gradient")
    with pytest.raises(ValueError, match="divisible"):
        step(state, torch.from_numpy(_images(41, b=3)), torch.Generator())


def test_warmup_grad_accum_step_matches_jax():
    check_grad_accum_step("warmup")
