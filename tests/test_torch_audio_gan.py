"""One GAN step of the port's DAC codec training (the discriminators'
step, then the generator's loss through the just-updated discriminators,
on one codec forward) against the JAX package's on the same weights and
the same RVQ draws; the helpers, sizes and tolerances are
``test_torch_audio_step.py``'s. Compared: every loss (the discriminators'
hinge, the generator's, feature matching and the reconstruction bundle),
the codec's and the discriminators' parameters after the update (a weight
whose reference gradient is below fp32's summation noise held through its
first moment only), the RVQ state, and both models' Adam first moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.training import audio as jaudio
from flocoder_tpu.training import vqgan as jvqgan
from flocoder_tpu.training.checkpoint import flatten_tree
from flocoder_torch.training import audio as taudio
from flocoder_torch.training.checkpoint import DISC_PREFIXES, to_jax_flat

from test_torch_audio_step import (B, LR, T, assert_codec, assert_updated, jax_draws, setup,
                                   waves)
from test_torch_vqgan_step import _assert_grads, _assert_losses, _jax_moments, _moments


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gan_step_matches_jax():
    s = setup()
    x = waves(5)
    key = jax.random.PRNGKey(6)
    tx = jaudio.make_audio_optimizer(LR)
    _, tx_d = jvqgan.make_vqgan_optimizers(LR, d_lr_scale=1.0)
    jstate = jvqgan.create_vqgan_state(s["jparams"], tx, s["jdvars"], tx_d)
    jstep = jaudio.make_audio_gan_step(s["jcodec"], tx, s["jdisc"], tx_d, s["jcfg"],
                                       donate=False)
    jstate, jaux, jidx = jax.block_until_ready(jstep(jstate, jnp.asarray(x), key))

    state = taudio.create_audio_state(s["codec"], s["disc"], LR)
    marks = []
    step = taudio.make_audio_gan_step(s["tcfg"])
    state, aux, idx = step(state, torch.from_numpy(x), None, mark=marks.append,
                           **jax_draws(key, B * T // s["codec"].hop))
    assert marks == ["codec_forward", "d_step", "g_loss_backward", "optimizers"]
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    _assert_losses(aux, jaux)
    assert {"gen", "feat", "d_loss"} <= set(aux)
    assert_codec(state, jstate)
    mu_ref = _jax_moments(jstate.opt_d, "params")
    assert_updated(to_jax_flat(state.disc, DISC_PREFIXES), flatten_tree(jstate.disc_vars),
                   mu_ref, "discriminators")
    _assert_grads(_moments(state.disc, state.opt_d, DISC_PREFIXES), mu_ref,
                  "discriminator gradient")
    assert all(p.requires_grad for p in state.disc.parameters())
