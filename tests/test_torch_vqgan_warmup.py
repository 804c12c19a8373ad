"""One warmup step (reconstruction only) of the port's codec training
against the JAX package's on the same weights; the helpers, sizes and
tolerances are ``test_torch_vqgan_step.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.training import vqgan as jvqgan
from flocoder_torch.training import vqgan as tvqgan
from flocoder_torch.training.checkpoint import VQVAE_PREFIXES
from test_torch_vqgan_step import (_assert_grads, _assert_losses, _assert_tree, _codec_flat,
                                   _images, _jax_codec_flat, _jax_moments, _moments, _setup)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_warmup_step_matches_jax():
    s = _setup()
    x = _images(20)
    tx_g, tx_d = jvqgan.make_vqgan_optimizers(1e-4)
    jstate = jvqgan.create_vqgan_state(s["jparams"], tx_g)
    jstep = jvqgan.make_vqgan_warmup_step(s["jcodec"], tx_g, s["jcfg"], s["jvgg"],
                                          donate=False)
    jstate, jaux, jidx = jax.block_until_ready(
        jstep(jstate, jnp.asarray(x), jax.random.PRNGKey(1)))

    state = tvqgan.create_vqgan_state(s["codec"], None, 1e-4)
    step = tvqgan.make_vqgan_warmup_step(s["tcfg"], s["vgg"], deterministic=True)
    state, aux, idx = step(state, torch.from_numpy(x), torch.Generator())
    _assert_losses(aux, jaux)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _assert_tree(_codec_flat(state.codec), _jax_codec_flat(jstate.params), "codec")
    _assert_grads(_moments(state.codec, state.opt_g, VQVAE_PREFIXES),
                  _jax_moments(jstate.opt_g, ""), "codec gradient")
    assert state.step == 1
