"""The port's codec training (flocoder_torch.training.vqgan) against the JAX
package's on the same weights: ``compute_vqgan_losses`` here, one warmup
step in ``test_torch_vqgan_warmup.py``, one GAN step in
``test_torch_vqgan_gan.py`` and the microbatched steps in
``test_torch_vqgan_accum.py`` (separate files, so that the test runner's
per-file workers take them in parallel; they import the helpers here),
comparing the losses, the codec's and the discriminator's parameters (and
power-iteration stats) after the update, and the RVQ state.

Both sides run deterministically: the JAX side through a test-side wrapper
of its ``VQVAE`` whose ``forward`` encodes and decodes with
``deterministic=True`` and no noise (nothing in flocoder_tpu changes), the
port with ``deterministic=True``. The RVQ state is initialised and has no
dead codes, so no random draw enters the step. The perceptual loss runs on
the same VGG16 weights (the port's seeded init, bridged). Small sizes:
16² images, hidden 16, two downsamples, a 16-wide discriminator.

Tolerances (fp32): losses and updated parameters 1e-4 absolute. Adam's
first update moves each weight by about ±lr whatever its gradient's size,
so the parameters show only each gradient's sign; the gradients themselves
are held through Adam's first moment after the step (0.1 · the clipped
gradient, torch's ``exp_avg`` against optax's ``mu``), for the codec and
for the discriminator, to 1e-4 · the largest |mu| of that model plus 1e-3
relative.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flocoder_tpu import metrics as jmetrics
from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.models import discriminator as jdisc
from flocoder_tpu.models.perceptual import VGG16Features as JaxVGG
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.training.checkpoint import flatten_tree, load_into_tree, unflatten_tree
from flocoder_torch import metrics as tmetrics
from flocoder_torch.config import load_config
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models import discriminator as tdisc
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.perceptual import VGG16Features, make_perceptual_fn
from flocoder_torch.training import vqgan as tvqgan
from flocoder_torch.training.checkpoint import (DISC_PREFIXES, VGG_PREFIXES,
                                                VQVAE_PREFIXES, to_jax_flat)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; one torch thread each
    keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-4
KW = dict(hidden_channels=16, num_downsamples=2, internal_dim=8,
          vq_embedding_dim=4, vq_num_embeddings=8, codebook_levels=2,
          commitment_weight=0.5)
OVERRIDES = ["codec.lambda_perc=0.001", "codec.learning_rate=0.0001"]
S = 16


class _DeterministicVQVAE(jcodecs.VQVAE):
    """The JAX codec with dropout and noise off and the RVQ in training."""

    def forward(self, params, x, train=False, rng=None, noise_strength=None,
                axis_name=None):
        z = self.encode(params, x, deterministic=True)
        z_q, idx, commit, new_vq = self.quantize(params, z, train=train, rng=rng,
                                                 axis_name=axis_name)
        return self.decode(params, z_q, deterministic=True, noise_strength=0.0), \
            commit, idx, new_vq


def _noisy(module, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(p.shape))
                                    .astype(np.float32)))
    return module


def _setup():
    """Port and JAX codec, discriminator and VGG on the same numbers; the
    port's modules are fresh copies for each caller (a step updates them)."""
    base = _base()
    return dict(base, codec=copy.deepcopy(base["codec"]),
                disc=copy.deepcopy(base["disc"]))


@functools.lru_cache(maxsize=1)
def _base():
    codec = _noisy(init_params(tcodecs.VQVAE(**KW), torch.Generator().manual_seed(0)), 1)
    rng = np.random.default_rng(2)
    L, K, D = codec.vq.codebooks.shape
    codec.vq.assign_({
        "codebooks": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32) * 0.5),
        "ema_counts": torch.from_numpy(rng.uniform(4, 30, (L, K)).astype(np.float32)),
        "ema_sums": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "initted": torch.tensor(True)})
    flat = to_jax_flat(codec, VQVAE_PREFIXES)
    tree = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    jparams = {"encoder": tree["encoder"], "decoder": tree["decoder"],
               "vq": JaxRVQState(**{k: tree["vq"][k] for k in
                                    ("codebooks", "ema_counts", "ema_sums", "initted")})}

    disc = _noisy(tdisc.init_discriminator(tdisc.VQGANPlusPatchDiscriminator(
        hidden_channels=16), torch.Generator().manual_seed(3)), 4)
    jd = jdisc.VQGANPlusPatchDiscriminator(hidden_channels=16)
    template = jdisc.init_discriminator(jd, jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    jdvars = load_into_tree(template, to_jax_flat(disc, DISC_PREFIXES), strict=True)

    vgg = init_params(VGG16Features(), torch.Generator().manual_seed(5))
    jvgg_vars = unflatten_tree({k: jnp.asarray(v)
                                for k, v in to_jax_flat(vgg, VGG_PREFIXES).items()})
    jvgg = JaxVGG()
    return dict(codec=codec, disc=disc, vgg=make_perceptual_fn(model=vgg),
                jcodec=_DeterministicVQVAE(**KW), jparams=jparams, jd=jd,
                jdvars=jdvars, jvgg=lambda x: jvgg.apply(jvgg_vars, x),
                tcfg=load_config("smoke_vqgan", config_dir="configs", overrides=OVERRIDES),
                jcfg=jload_config("smoke_vqgan", config_dir="configs", overrides=OVERRIDES))


def _images(seed, b=2):
    return np.random.default_rng(seed).uniform(-1, 1, size=(b, S, S, 3)).astype(np.float32)


def _assert_losses(taux, jaux):
    assert set(taux) == set(jaux), (sorted(taux), sorted(jaux))
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), atol=ATOL,
                                   err_msg=k)


def _assert_tree(ours: dict, ref: dict, what: str):
    assert set(ours) == set(ref), what
    for k in ref:
        np.testing.assert_allclose(np.asarray(ours[k], np.float64),
                                   np.asarray(ref[k], np.float64), atol=ATOL,
                                   err_msg=f"{what}: {k}")


def test_compute_vqgan_losses_matches_jax():
    s = _setup()
    recon, target = _images(10), _images(11)
    cfg_over = OVERRIDES + ["codec.lambda_ce=0.5"]
    tcfg = load_config("smoke_vqgan", config_dir="configs", overrides=cfg_over)
    jcfg = jload_config("smoke_vqgan", config_dir="configs", overrides=cfg_over)
    jdapply = jdisc.make_disc_apply(s["jd"])
    ref = jax.jit(lambda r, t: jmetrics.compute_vqgan_losses(
        r, t, jnp.asarray(0.3), jcfg, perceptual_fn=s["jvgg"], disc_apply=jdapply,
        disc_params=s["jdvars"], warmed_up=True))(jnp.asarray(recon), jnp.asarray(target))
    ours = tmetrics.compute_vqgan_losses(
        torch.from_numpy(recon), torch.from_numpy(target), torch.tensor(0.3), tcfg,
        perceptual_fn=s["vgg"], disc_apply=tdisc.make_disc_apply(s["disc"]),
        warmed_up=True)
    _assert_losses(ours, ref)
    np.testing.assert_allclose(float(tmetrics.get_total_vqgan_loss(ours, tcfg).detach()),
                               float(jmetrics.get_total_vqgan_loss(ref, jcfg)), atol=ATOL)
    np.testing.assert_allclose(
        float(tmetrics.spectral_loss(torch.from_numpy(recon), torch.from_numpy(target))),
        float(jmetrics.spectral_loss(jnp.asarray(recon), jnp.asarray(target))), rtol=1e-5)


def _codec_flat(codec):
    return to_jax_flat(codec, VQVAE_PREFIXES)


def _jax_codec_flat(params):
    return flatten_tree({"encoder": params["encoder"], "decoder": params["decoder"],
                         "vq": {k: getattr(params["vq"], k) for k in
                                ("codebooks", "ema_counts", "ema_sums", "initted")}})


def _jax_moments(opt_state, prefix: str) -> dict:
    """optax Adam's first moment as a flat JAX-layout dict."""
    isa = lambda s: isinstance(s, optax.ScaleByAdamState)
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=isa) if isa(s)]
    return flatten_tree({prefix: adam.mu} if prefix else adam.mu)


def _moments(module, opt, prefixes) -> dict:
    """torch Adam's first moment of each of ``module``'s optimised
    parameters, in the layout of ``to_jax_flat``."""
    m = copy.deepcopy(module)
    with torch.no_grad():
        for pm, p in zip(m.parameters(), module.parameters()):
            st = opt.state_of(p)
            pm.copy_(st["exp_avg"] if st else torch.full_like(p, float("nan")))
    return to_jax_flat(m, prefixes)


def _assert_grads(ours: dict, ref: dict, what: str):
    assert set(ref) <= set(ours), what
    scale = max(float(np.abs(np.asarray(v)).max()) for v in ref.values())
    assert scale > 0, what
    for k in ref:
        np.testing.assert_allclose(np.asarray(ours[k], np.float64),
                                   np.asarray(ref[k], np.float64), rtol=1e-3,
                                   atol=1e-4 * scale, err_msg=f"{what}: {k}")


def test_not_ported_options_raise():
    """Data parallelism is ported (tests/test_torch_parallel_codec.py): the
    steps take a mesh, and the degenerate one (``None``) is one device. A
    model axis needs a world of ranks (its ring attention is ported:
    tests/test_torch_ring_*.py); its tensor parallelism still raises,
    naming ROADMAP item 13b-ii."""
    from flocoder_torch import train_vqgan as ttv
    from flocoder_torch.parallel import mesh as pmesh
    cfg = load_config("smoke_vqgan", config_dir="configs")
    assert callable(tvqgan.make_vqgan_warmup_step(cfg, mesh=None))
    assert callable(tvqgan.make_vqgan_gan_step(cfg, mesh=None))
    with pytest.raises(RuntimeError, match="torchrun"):
        pmesh.make_mesh(n_model=2)
    with pytest.raises(NotImplementedError, match="ROADMAP.*13b-ii"):
        ttv.main(["--config-name", "smoke_vqgan", "+device=cpu", "+codec.tp=2"])
    with pytest.raises(ValueError, match="grad_accum"):
        tvqgan.make_vqgan_warmup_step(cfg, grad_accum=0)
    # codec.bf16 trains: both steps build and run with the codec, the
    # discriminator and the perceptual net computing in bf16 (noise and
    # dropout on), and the losses keep JAX's dtypes
    bf16 = load_config("smoke_vqgan", config_dir="configs",
                       overrides=["+codec.bf16=true", *OVERRIDES])
    assert tcodecs.setup_codec(bf16).dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(0)
    state = tvqgan.create_vqgan_state(
        tcodecs.VQVAE(**KW, dtype=torch.bfloat16).init(gen),
        tdisc.init_discriminator(tdisc.VQGANPlusPatchDiscriminator(
            hidden_channels=16, dtype=torch.bfloat16), gen), 1e-4)
    vgg = make_perceptual_fn(model=init_params(VGG16Features(torch.bfloat16), gen))
    x = torch.from_numpy(_images(12))
    for make, terms in ((tvqgan.make_vqgan_warmup_step, {"perceptual"}),
                        (tvqgan.make_vqgan_gan_step, {"perceptual", "g_loss", "d_loss"})):
        state, aux, idx = make(bf16, vgg)(state, x, gen)
        assert {k for k, v in aux.items() if v.dtype == torch.bfloat16} == terms
        assert all(aux[k].dtype == torch.float32 for k in ("mse", "vq", "total"))
        assert all(torch.isfinite(v.float()) for v in aux.values()) and idx.dtype == torch.int64
    gammas = [p for n, p in state.codec.named_parameters() if n.endswith("gamma")]
    assert gammas and all(g.dtype == torch.bfloat16 and float(g.detach().abs().max()) > 0
                          for g in gammas)
    assert all(p.dtype == torch.float32 for n, p in state.codec.named_parameters()
               if not n.endswith("gamma"))
