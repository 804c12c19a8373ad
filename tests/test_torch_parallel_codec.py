"""Data-parallel codec training: the port's warmup step on 2 gloo ranks
(each on its rows of a global batch of 4) against the JAX package's
``_mesh_wrap`` step on a 2-device mesh (gradients and losses ``pmean``ed,
RVQ statistics ``psum``ed) on the same weights; the GAN step (the
discriminator's gradients and power-iteration vectors ``pmean``ed too) in
``test_torch_parallel_codec_gan.py``, which imports the helpers here.
Sizes and tolerances are ``test_torch_vqgan_step.py``'s (losses and
updated parameters 1e-4 absolute, Adam's first moments 1e-4 · the model's
largest |μ| plus 1e-3 relative; the VQ indices exactly, each rank giving
its own rows), its codec without neighborhood attention and the losses
without the perceptual term: the reductions are the step's, whatever the
terms and layers, and the attention's and VGG16's compiles on the 2-device
mesh took most of the file's time (the single-device step tests hold
both). The JAX discriminator's variables come from a jitted init (an eager
one takes ~16 s).

The named mutation: the ranks without the mesh (each steps on its own
gradients, no mean) miss the JAX codec's first moments.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models import discriminator as jdisc
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flocoder_tpu.training import vqgan as jvqgan
from flocoder_tpu.training.checkpoint import flatten_tree, load_into_tree, unflatten_tree
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models import discriminator as tdisc
from flocoder_torch.models.layers import init_params
from flocoder_torch.training.checkpoint import DISC_PREFIXES, VQVAE_PREFIXES, to_jax_flat
from test_torch_parallel_ranks import codec_rank, start_ranks
from test_torch_vqgan_step import KW as STEP_KW
from test_torch_vqgan_step import (S, _DeterministicVQVAE, _assert_grads, _assert_tree,
                                   _images, _jax_codec_flat, _jax_moments, _noisy)

# the step tests' codec without its attention: the reductions are the
# step's, not the codec's, and neighborhood attention's compile on the
# 2-device mesh took most of the file's time (its parity is held by the
# single-device step tests and tests/test_torch_na2d*.py)
KW = dict(STEP_KW, use_attention=False, decoder_nonlocal=False)

OVERRIDES = ["codec.lambda_perc=0.0", "codec.learning_rate=0.0001"]


@functools.lru_cache(maxsize=None)
def setup(with_disc: bool):
    """The port's codec (and discriminator), the JAX twins on their
    numbers."""
    codec = _noisy(init_params(tcodecs.VQVAE(**KW), torch.Generator().manual_seed(0)), 1)
    rng = np.random.default_rng(2)
    L, K, D = codec.vq.codebooks.shape
    codec.vq.assign_({
        "codebooks": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32) * 0.5),
        "ema_counts": torch.from_numpy(rng.uniform(4, 30, (L, K)).astype(np.float32)),
        "ema_sums": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "initted": torch.tensor(True)})
    tree = unflatten_tree({k: jnp.asarray(v)
                           for k, v in to_jax_flat(codec, VQVAE_PREFIXES).items()})
    jparams = {"encoder": tree["encoder"], "decoder": tree["decoder"],
               "vq": JaxRVQState(**{k: tree["vq"][k] for k in
                                         ("codebooks", "ema_counts", "ema_sums", "initted")})}
    out = dict(codec=codec, jparams=jparams, jcodec=_DeterministicVQVAE(**KW),
               jcfg=jload_config("smoke_vqgan", config_dir="configs", overrides=OVERRIDES))
    if with_disc:
        disc = _noisy(tdisc.init_discriminator(tdisc.VQGANPlusPatchDiscriminator(
            hidden_channels=16), torch.Generator().manual_seed(3)), 4)
        jd = jdisc.VQGANPlusPatchDiscriminator(hidden_channels=16)
        template = jax.jit(lambda k, x: jdisc.init_discriminator(jd, k, x))(
            jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
        out.update(disc=disc, jd=jd, jdvars=load_into_tree(
            template, to_jax_flat(disc, DISC_PREFIXES), strict=True))
    return out


def models(s) -> dict:
    out = {"codec_cls": tcodecs.VQVAE, "codec_kw": KW, "codec_sd": s["codec"].state_dict(),
           "config": "smoke_vqgan", "prefixes": VQVAE_PREFIXES}
    if "disc" in s:
        out.update(disc_cls=tdisc.VQGANPlusPatchDiscriminator,
                   disc_kw={"hidden_channels": 16}, disc_sd=s["disc"].state_dict(),
                   disc_prefixes=DISC_PREFIXES)
    return out


def check_codec_step(tmp_path, kind):
    s = setup(kind == "gan")
    x = np.concatenate([_images(30), _images(31)])
    ranks = start_ranks(codec_rank, 2, tmp_path, kind, models(s), x, OVERRIDES, [True, False],
                        {})
    mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
    tx_g, tx_d = jvqgan.make_vqgan_optimizers(1e-4)
    if kind == "warmup":
        jstate = jvqgan.create_vqgan_state(s["jparams"], tx_g)
        jstep = jvqgan.make_vqgan_warmup_step(s["jcodec"], tx_g, s["jcfg"], None,
                                              donate=False, mesh=mesh)
    else:
        jstate = jvqgan.create_vqgan_state(s["jparams"], tx_g, s["jdvars"], tx_d)
        jstep = jvqgan.make_vqgan_gan_step(
            s["jcodec"], tx_g, s["jd"], jdisc.make_disc_apply(s["jd"], update_stats=True),
            jdisc.make_disc_apply(s["jd"]), tx_d, s["jcfg"], None, donate=False,
            mesh=mesh)
    jstate, jaux, jidx = jax.block_until_ready(jstep(jstate, jnp.asarray(x),
                                                     jax.random.PRNGKey(2)))
    both = ranks.join()
    res, cut = [r[0] for r in both], [r[1] for r in both]
    for k in jaux:
        for r in res:
            np.testing.assert_allclose(r["aux"][k], float(jaux[k]), atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(np.concatenate([r["idx"] for r in res]), np.asarray(jidx))
    ref_mu = _jax_moments(jstate.opt_g, "")
    for r in res:
        _assert_tree(r["codec"], _jax_codec_flat(jstate.params), "codec")
        _assert_grads(r["mu"], ref_mu, "codec gradient")
        if kind == "gan":
            _assert_tree(r["disc"], flatten_tree(jstate.disc_vars), "discriminator")
            _assert_grads(r["disc_mu"], _jax_moments(jstate.opt_d, "params"),
                          "discriminator gradient")

    # mutation: no cross-rank mean of the gradients
    with pytest.raises(AssertionError):
        for r in cut:
            _assert_grads(r["mu"], ref_mu, "codec gradient")


def test_two_rank_warmup_step_matches_jax_mesh(tmp_path):
    check_codec_step(tmp_path, "warmup")
