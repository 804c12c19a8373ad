"""The port's discriminators (flocoder_torch.models.discriminator) against
the JAX package's on the same weights and power-iteration state, handed
over by the weight bridge (DISC_PREFIXES): logits and features, and the
spectral-norm ``u``/``sigma`` after a discriminator step's two
``update_stats=True`` calls (real batch, then fake). Tolerance
1e-5·max(1, max|ref|) (fp32; features after GroupNorm reach ~3, and the
two frameworks sum a conv's products in different orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models import discriminator as jdisc
from flocoder_tpu.training.checkpoint import flatten_tree, load_into_tree
from flocoder_torch.models import discriminator as tdisc
from flocoder_torch.training.checkpoint import (DISC_PREFIXES, load_jax_flat,
                                                to_jax_flat)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; one torch thread each
    keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5

KINDS = [
    ("patch", lambda: jdisc.PatchDiscriminator(hidden_channels=16),
     lambda: tdisc.PatchDiscriminator(hidden_channels=16)),
    ("vqgan_plus_patch", lambda: jdisc.VQGANPlusPatchDiscriminator(hidden_channels=16),
     lambda: tdisc.VQGANPlusPatchDiscriminator(hidden_channels=16)),
    ("vqgan_plus", lambda: jdisc.VQGANPlusDiscriminator(base_channels=32),
     lambda: tdisc.VQGANPlusDiscriminator(base_channels=32)),
]


def _pair(make_jax, make_torch, x, seed):
    """A seeded port discriminator (plus N(0, 0.05²) noise on every weight)
    and the JAX variables holding the same numbers."""
    td = tdisc.init_discriminator(make_torch(), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in td.parameters():
            p.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(p.shape))
                                    .astype(np.float32)))
    jd = make_jax()
    template = jdisc.init_discriminator(jd, jax.random.PRNGKey(0), jnp.asarray(x))
    jvars = load_into_tree(template, to_jax_flat(td, DISC_PREFIXES), strict=True)
    return jd, jvars, td


def _images(seed, b=2, s=32):
    return np.random.default_rng(seed).uniform(-1, 1, size=(b, s, s, 3)).astype(np.float32)


def _close(ours, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref,
                               atol=ATOL * max(1.0, np.abs(ref).max()), err_msg=what)


@pytest.mark.parametrize("name,make_jax,make_torch", KINDS)
def test_logits_and_features_match_jax(name, make_jax, make_torch):
    x = _images(1)
    jd, jvars, td = _pair(make_jax, make_torch, x, 2)
    jlog, jfeat = jdisc.make_disc_apply(jd)(jvars, jnp.asarray(x))
    tlog, tfeat = tdisc.make_disc_apply(td)(torch.from_numpy(x))
    _close(tlog, jlog, "logits")
    assert len(tfeat) == len(jfeat)
    for i, (a, b) in enumerate(zip(tfeat, jfeat)):
        _close(a, b, f"feature {i}")


@pytest.mark.parametrize("name,make_jax,make_torch", KINDS)
def test_power_iteration_stats_after_a_d_step_match_jax(name, make_jax, make_torch):
    real, fake = _images(3), _images(4)
    jd, jvars, td = _pair(make_jax, make_torch, real, 5)
    train = jdisc.make_disc_apply(jd, update_stats=True)
    (jr, _), new = train(jvars, jnp.asarray(real))
    (jf, _), new = train({**new, "params": jvars["params"]}, jnp.asarray(fake))
    apply_t = tdisc.make_disc_apply(td, update_stats=True)
    tr, _ = apply_t(torch.from_numpy(real))
    tf, _ = apply_t(torch.from_numpy(fake))
    _close(tr, jr, "real logits")
    _close(tf, jf, "fake logits")
    ours = to_jax_flat(td, DISC_PREFIXES)
    ref = flatten_tree({"batch_stats": new["batch_stats"]})
    assert ref and all(k in ours for k in ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, atol=ATOL, err_msg=k)


def test_jax_variables_load_into_the_port_strictly():
    x = _images(6)
    jd = jdisc.VQGANPlusPatchDiscriminator(hidden_channels=16)
    jvars = jdisc.init_discriminator(jd, jax.random.PRNGKey(7), jnp.asarray(x))
    td = load_jax_flat(tdisc.VQGANPlusPatchDiscriminator(hidden_channels=16),
                       flatten_tree(jvars), DISC_PREFIXES)
    jlog, _ = jd.apply(jvars, jnp.asarray(x), update_stats=False)
    tlog, _ = td(torch.from_numpy(x))
    _close(tlog, jlog, "logits")
    with pytest.raises(KeyError, match="missing"):
        flat = flatten_tree(jvars)
        flat.pop("batch_stats/SpectralNorm_0/Conv_0/kernel/u")
        load_jax_flat(tdisc.VQGANPlusPatchDiscriminator(hidden_channels=16), flat,
                      DISC_PREFIXES)
