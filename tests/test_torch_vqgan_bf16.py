"""bf16 codec training (``codec.bf16``, ``tpu_vqgan.yaml``): one warmup step
here and one GAN step in ``test_torch_vqgan_bf16_gan.py`` (a file apart, so
that the test runner's per-file workers take the two in parallel) of the
port with the codec, the discriminator and the VGG16 perceptual net
computing in bf16 over fp32 parameters, against the JAX package's steps
with the same three built at ``dtype=bfloat16``, on the same weights; and
``NoiseInjection`` with its noise on.

Sizes: the codec of ``test_torch_vqgan_step.py`` with one downsample
(hidden 16, 16² images, NATTEN at 8² and 16²) at batch 8, a 16-wide
discriminator of two blocks, the recipe's ``share_real_features``; the
perceptual term (λ 1e-3) in the warmup step, not in the GAN step (its VGG
forward and backward would take the GAN case's JAX compile past half a
minute). Weights cross by the bridge; NATTEN's gamma is set to 2e-3
(bf16), small enough that one Adam step moves it by many of its bf16
spacings. Dropout and noise are off in the steps; the RVQ is initialised,
with no dead codes.

The JAX steps run jitted with XLA's excess precision off (otherwise XLA
keeps bf16 intermediates unrounded) and its backend optimisations off (a
shorter compile). Two things make two sound bf16 steps differ beyond one
rounding, and the test takes each out by a rule, the one `chip_smoke.py`
holds the card to the CPU by (``forced_picks``, ``worst_pick_gap``,
``hold_bf16_moments``, its constants ``BF16_*`` and ``PICK_GAP``):

- the RVQ's picks flip at near ties when the encoder's output rounds
  differently, and one flipped token moves every gradient. So the JAX step
  is traced on the port's picks, and the picks JAX makes on its own must
  equal the port's except at near ties: where the least relative change
  of the residual that swaps the two codes is below ``PICK_GAP`` (5e-2);
- bf16 gradients are sums whose rounding moves each element by a share of
  its tensor's largest value. The fp32 step of the port on the same picks
  (which ``test_torch_vqgan_step.py`` holds to JAX's fp32 step at 1e-4)
  gives each tensor's spread: the largest |JAX bf16 − fp32|. A scalar's
  spread is one sample of a sum that cancels (a NATTEN gamma's), so the
  gammas are held as one vector, against the largest of their moments.

Held, each tensor against its own largest |ref| (never a model's):

- the loss terms within 3e-2·max(1, |ref|), and their dtypes equal to
  JAX's (mse, vq and the total fp32; the perceptual, generator and
  discriminator terms bf16);
- Adam's first moments of every codec and discriminator tensor
  elementwise within 3e-2 of the tensor's largest |ref| plus 2.5 times its
  spread; a tensor whose spread is at least half its largest |ref| (its
  fp32 gradient is nought to bf16 rounding: a bias before a GroupNorm of
  one channel a group, an attention key's bias) is left out and counted
  (at most a tenth of a model's tensors); a tensor JAX's gradient does not
  reach (``NoiseInjection``'s, noise off) must be exactly 0; the readings
  are printed (run a file alone with ``-s``);
- each NATTEN ``gamma`` (a bf16 parameter) after the step within two of
  its bf16 spacings of JAX's where its gradient's sign is not rounding's,
  and moved by about the learning rate;
- the median |change| of every model's parameters about the learning rate;
- spectral norm's ``u`` and σ after the discriminator step within 1e-5 of
  JAX's (fp32 on both sides);
- the dtypes of the reconstruction, the discriminator's logits and
  features, the perceptual features and a ``NoiseInjection`` output with
  noise on equal to JAX's (``jax.eval_shape`` of the same modules).
"""
import contextlib
import functools

import chip_smoke
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.models import discriminator as jdisc
from flocoder_tpu.models.perceptual import VGG16Features as JaxVGG
from flocoder_tpu.ops import rvq as jrvq
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.training import vqgan as jvqgan
from flocoder_tpu.training.checkpoint import flatten_tree, load_into_tree, unflatten_tree
from flocoder_torch.config import load_config
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models import discriminator as tdisc
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.perceptual import VGG16Features, make_perceptual_fn
from flocoder_torch.training import vqgan as tvqgan
from flocoder_torch.training.checkpoint import (DISC_PREFIXES, VGG_PREFIXES,
                                                VQVAE_PREFIXES, load_jax_flat, to_jax_flat)
from test_torch_codec_bf16 import _jax_params
from test_torch_vqgan_step import (KW, OVERRIDES, S, _DeterministicVQVAE, _jax_moments,
                                   _moments, _noisy)

LR, D_LR_SCALE, GAMMA = 1e-4, 1e-3, 2e-3
B = 8
CODEC = dict(KW, num_downsamples=1)     # NATTEN at 8² (encoder) and 16² (decoder)
DISC = dict(hidden_channels=16, n_layers=2)
# the recipe's shared real features; the GAN step without the perceptual
# term, which the warmup step holds (its VGG forward and backward would
# take the GAN case's JAX compile past half a minute)
CFG = {"warmup": [*OVERRIDES, "+codec.share_real_features=true"],
       "gan": [*OVERRIDES, "+codec.share_real_features=true", "codec.lambda_perc=0.0"]}
XLA_OPTIONS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_noise_injection_keeps_bf16():
    """With its noise on, ``NoiseInjection`` keeps a bf16 block in bf16, as
    the JAX module does, and equals x + s·(noise·scale(x) + bias(x)) on its
    draw; a bf16 codec's training forward (noise and dropout on) gives
    bf16 reconstructions."""
    ni = init_params(tcodecs.NoiseInjection(8, dtype=torch.bfloat16),
                     torch.Generator().manual_seed(0))
    _noisy(ni, 1)
    x = torch.randn(2, 8, 4, 4, generator=torch.Generator().manual_seed(2)).bfloat16()
    with torch.no_grad():
        out = ni(x, strength=0.05, generator=torch.Generator().manual_seed(3))
        noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).bfloat16()
        ref = x + 0.05 * (noise * ni.Conv_0(x) + ni.Conv_1(x))
    jni = jcodecs.NoiseInjection(dtype=jnp.bfloat16)
    xj = jnp.zeros((2, 4, 4, 8), jnp.bfloat16)
    jout = jax.eval_shape(lambda: jni.apply(jni.init(jax.random.PRNGKey(0), xj), xj,
                                            noise_strength=0.05,
                                            rngs={"noise": jax.random.PRNGKey(1)}))
    assert out.dtype == torch.bfloat16 and jout.dtype == jnp.bfloat16
    assert torch.equal(out, ref) and not torch.equal(out, x)
    codec = tcodecs.VQVAE(**CODEC, dtype=torch.bfloat16).init(torch.Generator().manual_seed(4))
    with torch.no_grad():
        recon = codec(torch.from_numpy(_batch(5)), train=True,
                      generator=torch.Generator().manual_seed(6))[0]
    assert recon.dtype == torch.bfloat16 and torch.isfinite(recon.float()).all()


@pytest.mark.parametrize("n", [7, 1000, 65536])
def test_bf16_mean_rounds_once_as_jnp_mean(n):
    """The losses' bf16 means: torch's ``mean`` of a bf16 tensor equals
    ``jnp.mean`` of the same values (fp32 accumulation, one rounding to
    bf16) and the fp32 mean rounded once."""
    rng = np.random.default_rng(n)
    for scale in (0.01, 1.0, 30.0):
        x = (rng.normal(size=n) * scale + 0.3 * scale).astype(np.float32)
        t = torch.from_numpy(x).bfloat16()
        ours = t.mean()
        ref = jnp.mean(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16))
        assert ours.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
        assert float(ours) == float(ref) == float(t.float().mean().bfloat16())


def _batch(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (B, S, S, 3)).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _weights() -> dict:
    """The port's seeded weights plus noise, as JAX-layout flats: the codec
    through a bf16 codec (gamma rounded to bf16, set to ``GAMMA``), the
    discriminator and the VGG."""
    codec = _noisy(init_params(tcodecs.VQVAE(**CODEC), torch.Generator().manual_seed(0)), 1)
    with torch.no_grad():
        for name, p in codec.named_parameters():
            if name.endswith("gamma"):
                p.fill_(GAMMA)
    rng = np.random.default_rng(2)
    L, K, D = codec.vq.codebooks.shape
    codec.vq.assign_({
        "codebooks": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32) * 0.5),
        "ema_counts": torch.from_numpy(rng.uniform(4, 30, (L, K)).astype(np.float32)),
        "ema_sums": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "initted": torch.tensor(True)})
    bf16 = tcodecs.VQVAE(**CODEC, dtype=torch.bfloat16)
    flat = to_jax_flat(load_jax_flat(bf16, to_jax_flat(codec, VQVAE_PREFIXES), VQVAE_PREFIXES),
                       VQVAE_PREFIXES)
    disc = _noisy(tdisc.init_discriminator(tdisc.VQGANPlusPatchDiscriminator(**DISC),
                                           torch.Generator().manual_seed(3)), 4)
    vgg = init_params(VGG16Features(), torch.Generator().manual_seed(5))
    return dict(flat=flat, dflat=to_jax_flat(disc, DISC_PREFIXES),
                vflat=to_jax_flat(vgg, VGG_PREFIXES))


@contextlib.contextmanager
def _jax_picks(picks, own: dict):
    """While a JAX step is traced its quantizer takes ``picks`` likewise;
    when it runs, each level's residual, codebook and own nearest codes go
    to ``own[level]``."""
    plain_level, plain = jrvq._quantize_level, jrvq._sq_dists
    calls = [0]

    def dists(z, cb):
        d = plain(z, cb)
        jax.debug.callback(lambda r, c, i, lvl=calls[0]: own.__setitem__(
            lvl, (np.asarray(i), np.asarray(r, np.float64), np.asarray(c, np.float64))),
            z, cb, jnp.argmin(d, axis=1))
        want = jnp.asarray(picks[:, calls[0]])
        return d.at[jnp.arange(len(want)), want].set(-jnp.inf)

    def level(z, cb, rotation_trick):
        jrvq._sq_dists = dists
        try:
            return plain_level(z, cb, rotation_trick)
        finally:
            jrvq._sq_dists = plain
            calls[0] += 1

    jrvq._quantize_level = level
    try:
        yield
    finally:
        jrvq._quantize_level = plain_level


def _port_step(phase: str, x, dtype, picks=None) -> dict:
    w = _weights()
    codec = load_jax_flat(tcodecs.VQVAE(**CODEC, dtype=dtype), w["flat"], VQVAE_PREFIXES)
    disc = (load_jax_flat(tdisc.VQGANPlusPatchDiscriminator(**DISC, dtype=dtype), w["dflat"],
                          DISC_PREFIXES) if phase == "gan" else None)
    vgg = make_perceptual_fn(model=load_jax_flat(VGG16Features(dtype), w["vflat"],
                                                 VGG_PREFIXES))
    state = tvqgan.create_vqgan_state(codec, disc, LR)
    before = {m: {n: p.detach().clone() for n, p in mod.named_parameters()}
              for m, mod in (("codec", codec), ("disc", disc)) if mod is not None}
    make = tvqgan.make_vqgan_warmup_step if phase == "warmup" else tvqgan.make_vqgan_gan_step
    cfg = load_config("smoke_vqgan", config_dir="configs", overrides=CFG[phase])
    searches = None if picks is None else [picks[:, i] for i in range(picks.shape[1])]
    with chip_smoke.forced_picks(searches, []):
        state, aux, idx = make(cfg, vgg, deterministic=True)(state, torch.from_numpy(x),
                                                             torch.Generator())
    return dict(state=state, aux=aux, vgg=vgg, before=before,
                picks=idx.reshape(-1, idx.shape[-1]).numpy())


def _jax_step(phase: str, x, picks) -> dict:
    """JAX's ``phase`` step in bf16 on the port's picks: the states before
    and after, the losses, JAX's own picks, and the models for
    ``eval_shape``."""
    w = _weights()
    jcodec = _DeterministicVQVAE(**CODEC, dtype=jnp.bfloat16)
    x0 = jnp.zeros((1, S, S, 3))
    template = jax.eval_shape(jcodec.init, jax.random.PRNGKey(0), x0)
    params = _jax_params({"encoder": template["encoder"], "decoder": template["decoder"]},
                         {k: v for k, v in w["flat"].items() if not k.startswith("vq/")})
    params["vq"] = JaxRVQState(**{k.split("/")[1]: jnp.asarray(v)
                                  for k, v in w["flat"].items() if k.startswith("vq/")})
    jvgg, vgg_vars = JaxVGG(dtype=jnp.bfloat16), unflatten_tree(
        {k: jnp.asarray(v) for k, v in w["vflat"].items()})
    feat = lambda v: jvgg.apply(vgg_vars, v)                         # noqa: E731
    cfg = jload_config("smoke_vqgan", config_dir="configs", overrides=CFG[phase])
    tx_g, tx_d = jvqgan.make_vqgan_optimizers(LR, d_lr_scale=D_LR_SCALE)
    jd = jdvars = None
    if phase == "warmup":
        state0 = jvqgan.create_vqgan_state(params, tx_g)
        step = jvqgan.make_vqgan_warmup_step(jcodec, tx_g, cfg, feat, donate=False)
    else:
        jd = jdisc.VQGANPlusPatchDiscriminator(**DISC, dtype=jnp.bfloat16)
        shapes = jax.eval_shape(lambda: jdisc.init_discriminator(jd, jax.random.PRNGKey(0), x0))
        jdvars = load_into_tree(jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                                       shapes), w["dflat"], strict=True)
        state0 = jvqgan.create_vqgan_state(params, tx_g, jdvars, tx_d)
        step = jvqgan.make_vqgan_gan_step(
            jcodec, tx_g, jd, jdisc.make_disc_apply(jd, update_stats=True),
            jdisc.make_disc_apply(jd), tx_d, cfg, feat, donate=False)
    args = (state0, jnp.asarray(x), jax.random.PRNGKey(1))
    own: dict = {}
    with _jax_picks(picks, own):
        lowered = step.lower(*args)
    state, aux, _ = jax.block_until_ready(lowered.compile(compiler_options=XLA_OPTIONS)(*args))
    return dict(state0=state0, state=state, aux=aux, own=own, jcodec=jcodec, params=params,
                jvgg=jvgg, vgg_vars=vgg_vars, jd=jd, jdvars=jdvars)


def run_bf16_step(phase: str) -> None:
    """One ``phase`` step (warmup or gan) of both packages in bf16, held."""
    x = _batch(20)
    port = _port_step(phase, x, torch.bfloat16)
    picks = port["picks"]
    fp32 = _port_step(phase, x, torch.float32, picks)
    ref = _jax_step(phase, x, picks)
    levels = sorted(ref["own"])
    assert chip_smoke.worst_pick_gap([picks[:, i] for i in levels],
                                     [ref["own"][i] for i in levels]) < chip_smoke.PICK_GAP

    state, aux, jaux = port["state"], port["aux"], ref["aux"]
    assert set(aux) == set(jaux), (sorted(aux), sorted(jaux))
    for k, v in jaux.items():
        assert aux[k].dtype == getattr(torch, str(v.dtype)), k
        np.testing.assert_allclose(float(aux[k].float()), float(v),
                                   atol=3e-2 * max(1.0, abs(float(v))), err_msg=k)

    models = [("codec", "opt_g", VQVAE_PREFIXES, "", LR)]
    if phase == "gan":
        models.append(("disc", "opt_d", DISC_PREFIXES, "params", LR * D_LR_SCALE))
    for what, opt, prefixes, jprefix, rate in models:
        module = getattr(state, what)
        ours, f32 = (_moments(getattr(st, what), getattr(st, opt), prefixes)
                     for st in (state, fp32["state"]))
        jmu = _jax_moments(getattr(ref["state"], opt), jprefix)
        held = chip_smoke.hold_bf16_moments(ours, jmu, f32)
        print(f"{what} first moments: {held['tensors']} tensors; of those held, "
              f"{held['beyond_rel']} lie beyond {chip_smoke.BF16_REL:g} of their largest "
              f"|ref|, JAX's own bf16 moments lie beyond it from fp32's on "
              f"{held['ref_beyond_rel_from_fp32']}; the worst needs "
              f"{held['worst_need_of_spread']:.2f}× its spread; left out {held['left_out']}")
        assert not held["failures"], f"{what}: " + "; ".join(held["failures"][:6])
        if what == "codec":
            gamma_mu = {n: (float(ours[n][0]), float(np.asarray(jmu[n], np.float32)[0]),
                            float(f32[n][0])) for n in jmu if n.endswith("/gamma")}
        change = np.concatenate([(p.detach().double() - port["before"][what][n].double())
                                 .abs().flatten().numpy() / rate
                                 for n, p in module.named_parameters()])
        assert 0.5 < np.median(change) < 1.5, f"{what}: median change {np.median(change)}·lr"

    # gamma: bf16, moved by about lr, within two bf16 spacings of JAX's
    jflat = flatten_tree({"encoder": ref["state"].params["encoder"],
                          "decoder": ref["state"].params["decoder"]})
    ours = to_jax_flat(state.codec, VQVAE_PREFIXES)
    gammas = [n for n in jflat if n.endswith("gamma")]
    assert gammas and all(jflat[n].dtype == jnp.bfloat16 for n in gammas)
    for n in gammas:
        p = dict(state.codec.named_parameters())[n.replace("/params/", ".").replace("/", ".")]
        assert p.dtype == torch.bfloat16
        got, want = float(ours[n][0]), float(np.asarray(jflat[n], np.float32)[0])
        assert 0.5 * LR < abs(got - GAMMA) < 1.5 * LR, (n, got)
        _, mu, mu32 = gamma_mu[n]
        if abs(mu - mu32) < chip_smoke.BF16_NOUGHT * abs(mu):   # sign not rounding's
            spacing = float(np.spacing(np.float32(abs(want)))) * 2.0 ** 16
            assert abs(got - want) <= 2 * spacing, (n, got, want)

    # dtypes of the models' outputs against JAX's (eval_shape)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        recon = state.codec(xt, train=True, deterministic=True)[0]
        feats = port["vgg"](xt)
    jrecon = jax.eval_shape(lambda p, v: ref["jcodec"].forward(p, v, train=True)[0],
                            ref["params"], jnp.asarray(x))
    jfeats = jax.eval_shape(lambda v: ref["jvgg"].apply(ref["vgg_vars"], v), jnp.asarray(x))
    assert recon.dtype == getattr(torch, str(jrecon.dtype)) == torch.bfloat16
    assert [str(f.dtype) for f in feats] == [f"torch.{f.dtype}" for f in jfeats]
    if phase == "gan":
        with torch.no_grad():
            logits, dfeats = state.disc(recon)
        jlogits, jdfeats = jax.eval_shape(lambda v: ref["jd"].apply(ref["jdvars"], v), jrecon)
        assert [str(t.dtype) for t in (logits, *dfeats)] == [
            f"torch.{t.dtype}" for t in (jlogits, *jdfeats)]
        assert logits.dtype == torch.bfloat16
        # spectral norm's u and σ after the D step, fp32 on both sides
        jstats = flatten_tree(ref["state"].disc_vars["batch_stats"])
        sn = {k[len("batch_stats/"):]: v for k, v in to_jax_flat(state.disc, DISC_PREFIXES).items()
              if k.startswith("batch_stats/")}
        assert set(sn) == set(jstats)
        for k, v in jstats.items():
            assert sn[k].dtype == np.float32 and np.asarray(v).dtype == np.float32
            np.testing.assert_allclose(sn[k], np.asarray(v), rtol=0,
                                       atol=1e-5 * max(1.0, float(np.abs(v).max())), err_msg=k)
        j0 = flatten_tree(ref["state0"].disc_vars["batch_stats"])
        assert any(not np.array_equal(np.asarray(j0[k]), np.asarray(v))
                   for k, v in jstats.items())


def test_bf16_warmup_step_matches_jax():
    run_bf16_step("warmup")
