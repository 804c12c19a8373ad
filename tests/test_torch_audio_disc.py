"""The port's waveform discriminators (flocoder_torch.models.audio_disc)
against the JAX package's on the same weights (every parameter random,
bridged through ``to_jax_flat``; keys and shapes against flax's tree) and
the same numpy waveforms: a period view on lengths that do not divide by
its period (the reversed-tail pad), the pooled scale views (``SAME`` zero
pad counted in the mean, grouped k-41 convolutions), and the ensemble's
logits and feature maps in the JAX order, each compared in the JAX
package's channels-last layout. Tolerance: 1e-5·max(1, |ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models import audio_disc as jdisc
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch.models import audio_disc as tdisc
from flocoder_torch.training.checkpoint import DISC_PREFIXES, to_jax_flat

from test_torch_audio_codec import flax_paths, randomize

DKW = dict(base_channels=4, n_layers=3, max_channels=32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _channels_last(t: torch.Tensor) -> np.ndarray:
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _close(ours, ref, what=""):
    ref = np.asarray(ref, np.float64)
    ours = _channels_last(ours).astype(np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=what)


def _bridged(module, jmodule, t, seed):
    randomize(module, seed, scale=1.0)
    flat = to_jax_flat(module, DISC_PREFIXES)
    shapes = flax_paths(jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), jnp.zeros((1, t, 1))))
    assert {k: v.shape for k, v in flat.items()} == shapes
    return unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})


def _waves(seed, t):
    return np.random.default_rng(seed).uniform(-1, 1, size=(2, t, 1)).astype(np.float32)


@pytest.mark.parametrize("p,t", [(2, 101), (3, 100), (5, 96), (7, 97), (11, 121)])
def test_period_discriminator_matches_jax(p, t):
    disc = tdisc.PeriodDiscriminator(p, **DKW)
    jd = jdisc.PeriodDiscriminator(p, **DKW)
    variables = _bridged(disc, jd, t, p)
    x = _waves(p + t, t)
    ref_logits, ref_feats = jax.jit(lambda v: jd.apply(variables, v))(x)
    logits, feats = disc(torch.from_numpy(x))
    _close(logits, ref_logits, "logits")
    assert logits.shape[-1] == p and len(feats) == len(ref_feats) == DKW["n_layers"] + 1
    for i, (f, rf) in enumerate(zip(feats, ref_feats)):
        _close(f, rf, f"feature {i}")


@pytest.mark.parametrize("pool,t", [(1, 160), (2, 161), (4, 163), (4, 160)])
def test_scale_discriminator_matches_jax(pool, t):
    disc = tdisc.ScaleDiscriminator(pool, base_channels=16, n_layers=2, max_channels=128)
    jd = jdisc.ScaleDiscriminator(pool, base_channels=16, n_layers=2, max_channels=128)
    variables = _bridged(disc, jd, t, pool)
    assert [c.groups for c in disc.convs] == [1, 4, 4, 1, 1]      # c // 16, at most 4
    x = _waves(pool + t, t)
    ref_logits, ref_feats = jax.jit(lambda v: jd.apply(variables, v))(x)
    logits, feats = disc(torch.from_numpy(x))
    _close(logits, ref_logits, "logits")
    for i, (f, rf) in enumerate(zip(feats, ref_feats)):
        _close(f, rf, f"feature {i}")


def test_ensemble_matches_jax_in_order():
    kw = dict(periods=(2, 3, 5), scales=3, **DKW)
    disc, jd = tdisc.DACDiscriminator(**kw), jdisc.DACDiscriminator(**kw)
    variables = _bridged(disc, jd, 203, 0)
    assert [n for n, _ in disc.named_children()] == ["mpd_2", "mpd_3", "mpd_5", "msd_1",
                                                     "msd_2", "msd_4"]
    x = _waves(1, 203)
    ref_logits, ref_feats = jax.jit(lambda v: jd.apply(variables, v))(x)
    for inp in (x, x[..., 0]):              # (B, T, 1) and (B, T)
        logits, feats = disc(torch.from_numpy(inp))
        assert len(logits) == len(ref_logits) == 6
        for i, (lg, rl) in enumerate(zip(logits, ref_logits)):
            _close(lg, rl, f"logits {i}")
            assert lg.dtype == torch.float32
            for j, (f, rf) in enumerate(zip(feats[i], ref_feats[i])):
                _close(f, rf, f"view {i} feature {j}")


def test_audio_dac_discriminators_at_full_width():
    """``audio_dac.yaml``'s ensemble (periods 2, 3, 5, 7, 11; 3 scales; base
    16): 26,850,280 parameters, flax's tree."""
    kw = dict(periods=(2, 3, 5, 7, 11), scales=3, base_channels=16)
    disc = tdisc.DACDiscriminator(**kw)
    shapes = flax_paths(jax.eval_shape(jdisc.DACDiscriminator(**kw).init,
                                       jax.random.PRNGKey(0), jnp.zeros((1, 32768, 1))))
    flat = to_jax_flat(disc, DISC_PREFIXES)
    assert {k: v.shape for k, v in flat.items()} == shapes
    assert sum(v.size for v in flat.values()) == 26850280
