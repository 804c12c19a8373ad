"""The port's DAC codec training (flocoder_torch.training.audio) against the
JAX package's on the same weights: ``audio_codec_losses`` and one
reconstruction step here, one GAN step in ``test_torch_audio_gan.py`` (a
separate file, so that the test runner's per-file workers take them in
parallel; it imports the helpers here).

Every weight of the codec and of the discriminators is random (the
codec's zero-initialised convolutions and ``log_alpha`` included,
``test_torch_audio_codec.randomize``). The RVQ state is fresh (not
initialised), so the step runs the k-means initialisation and reseeds the
codes that come out dead; the port is handed the JAX step's own draws (its
k-means seed rows and reseed picks, recomputed from the step's key as
``tests/test_torch_rvq.py`` does). Tiny sizes: strides (2, 4), base 4, RVQ
2 levels × 16 codes of 4, B=2 clips of 256 samples, FFT sizes 64/128/256;
discriminators with periods 2 and 3, 2 scales, base 4.

Tolerances (fp32), ``tests/test_torch_vqgan_step.py``'s rule: losses and
updated parameters (and the RVQ state) 1e-4 absolute; Adam's first moments
after the step to 1e-4 · the largest |μ| of that model plus 1e-3 relative.
Adam's first update moves a weight by about ±lr whatever its gradient's
size, so where the reference gradient is below fp32's summation noise
(|μ| < 1e-5 · the model's largest |μ|) the two packages' updates may take
opposite signs (up to 2·lr apart): a weight off by more than 1e-4 passes
only there, at most 0.1% of its tensor, held through its first moment.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models import audio_codec as jac
from flocoder_tpu.models import audio_disc as jdisc
from flocoder_tpu.training import audio as jaudio
from flocoder_tpu.training import vqgan as jvqgan
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch.config import load_config
from flocoder_torch.models import audio_codec as tac
from flocoder_torch.models import audio_disc as tdisc
from flocoder_torch.training import audio as taudio
from flocoder_torch.training.checkpoint import DAC_PREFIXES, DISC_PREFIXES, to_jax_flat

from test_torch_audio_codec import KW, jax_params, randomize
from test_torch_vqgan_step import (ATOL, _assert_grads, _assert_losses, _jax_codec_flat,
                                   _jax_moments, _moments)

OVERRIDES = ["codec.strides=[2,4]", "codec.base_channels=4", "codec.vq_embedding_dim=4",
             "codec.codebook_levels=2", "codec.vq_num_embeddings=16",
             "codec.fft_sizes=[64,128,256]", "codec.n_mels=[16,32,64]",
             "codec.learning_rate=1e-4"]
DKW = dict(periods=(2, 3), scales=2, base_channels=4)
LR, B, T = 1e-4, 2, 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _base():
    codec = randomize(tac.DACCodec(**KW).init(torch.Generator().manual_seed(0)), 1)
    disc = randomize(tdisc.DACDiscriminator(**DKW), 3)
    jdvars = unflatten_tree({k: jnp.asarray(v) for k, v in to_jax_flat(disc, DISC_PREFIXES).items()})
    return dict(codec=codec, disc=disc, jparams=jax_params(codec), jdvars=jdvars,
                jcodec=jac.DACCodec(**KW), jdisc=jdisc.DACDiscriminator(**DKW),
                tcfg=load_config("audio_dac", "configs", OVERRIDES),
                jcfg=jload_config("audio_dac", "configs", OVERRIDES))


def setup():
    """The port's modules are fresh copies for each caller (a step updates
    them in place)."""
    base = _base()
    return dict(base, codec=copy.deepcopy(base["codec"]), disc=copy.deepcopy(base["disc"]))


def waves(seed):
    return np.random.default_rng(seed).uniform(-0.8, 0.8, size=(B, T, 1)).astype(np.float32)


def jax_draws(key, n_tokens: int) -> dict:
    """The JAX RVQ's k-means seed rows and reseed picks for ``key``."""
    L, K = KW["codebook_levels"], KW["vq_num_embeddings"]
    seeds = [np.asarray(jax.random.randint(k, (K,), 0, n_tokens))
             for k in jax.random.split(key, L)]
    picks = [np.asarray(jax.random.randint(jax.random.fold_in(key, lvl + 1), (K,), 0, n_tokens))
             for lvl in range(L)]
    return {"kmeans_seeds": np.stack(seeds), "reseed_picks": np.stack(picks)}


def assert_updated(ours: dict, ref: dict, mu_ref: dict, what: str) -> int:
    """The updated parameters within 1e-4; a weight outside it passes only
    where its reference gradient is below the noise floor (module
    docstring), at most 0.1% of a tensor. Returns how many did."""
    scale = max(float(np.abs(np.asarray(v)).max()) for v in mu_ref.values())
    assert set(ours) == set(ref), what
    noise = 0
    for k in ref:
        a, b = np.asarray(ours[k], np.float64), np.asarray(ref[k], np.float64)
        off = np.abs(a - b) > ATOL + 1e-7 * np.abs(b)
        if k in mu_ref and off.any():
            floor = np.abs(np.asarray(mu_ref[k])) < 1e-5 * scale
            assert off.mean() <= 1e-3 and floor[off].all(), (what, k, int(off.sum()))
            noise += int(off.sum())
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=1e-7, err_msg=f"{what}: {k}")
    return noise


def assert_codec(state, jstate):
    mu_ref = _jax_moments(jstate.opt_g, "")
    assert_updated(to_jax_flat(state.codec, DAC_PREFIXES), _jax_codec_flat(jstate.params),
                   mu_ref, "codec")
    _assert_grads(_moments(state.codec, state.opt_g, DAC_PREFIXES), mu_ref, "codec gradient")


def test_audio_codec_losses_match_jax():
    s = setup()
    recon, target = waves(1), waves(2)
    ref = jax.jit(lambda r, t: jaudio.audio_codec_losses(
        r, t, jnp.asarray(0.3), jaudio._loss_cfg(s["jcfg"])))(recon, target)
    ours = taudio.audio_codec_losses(torch.from_numpy(recon), torch.from_numpy(target),
                                     torch.tensor(0.3), taudio._loss_cfg(s["tcfg"]))
    _assert_losses(ours, ref)
    # the STFT term takes the first two FFT sizes only
    assert taudio._loss_cfg(s["tcfg"])["fft_sizes"] == (64, 128, 256)


def test_optimizers_follow_optax():
    s = setup()
    state = taudio.create_audio_state(s["codec"], s["disc"], LR, d_lr_scale=0.5)
    assert state.opt_g.betas == (0.8, 0.99) and state.opt_g.lr == LR
    assert state.opt_d.betas == (0.9, 0.999) and state.opt_d.lr == LR * 0.5
    assert state.opt_g.adam.param_groups[0]["betas"] == (0.8, 0.99)
    assert len(state.opt_g.params) == len(list(s["codec"].encoder.parameters())) + len(
        list(s["codec"].decoder.parameters()))
    # data parallelism is ported (tests/test_torch_parallel_codec.py); the
    # degenerate mesh is one device, and tensor parallelism still raises
    assert callable(taudio.make_audio_train_step(s["tcfg"], mesh=None))
    assert callable(taudio.make_audio_gan_step(s["tcfg"], mesh=None))
    from flocoder_torch import train_audio_codec as tac
    with pytest.raises(NotImplementedError, match="ROADMAP.*13b"):
        tac.main(["--config-name", "audio_dac", "+device=cpu", "+codec.tp=2"])


def test_recon_step_matches_jax():
    s = setup()
    x = waves(3)
    key = jax.random.PRNGKey(4)
    tx = jaudio.make_audio_optimizer(LR)
    jstate = jvqgan.create_vqgan_state(s["jparams"], tx)
    jstep = jaudio.make_audio_train_step(s["jcodec"], tx, s["jcfg"], donate=False)
    jstate, jaux, jidx = jax.block_until_ready(jstep(jstate, jnp.asarray(x), key))

    state = taudio.create_audio_state(s["codec"], None, LR)
    step = taudio.make_audio_train_step(s["tcfg"])
    state, aux, idx = step(state, torch.from_numpy(x), None,
                           **jax_draws(key, B * T // s["codec"].hop))
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    _assert_losses(aux, jaux)
    assert_codec(state, jstate)
    assert bool(state.codec.vq.initted) and state.step == 1
