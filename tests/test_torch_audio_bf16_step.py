"""One reconstruction step of a bf16 DAC codec here, and one GAN step in
``test_torch_audio_bf16_gan.py`` (a file apart, so that the test runner's
per-file workers take the two in parallel), against the JAX package's
steps with ``DACCodec(dtype=bfloat16)``: the encoder and decoder compute in
bf16 over fp32 parameters; the RVQ, the losses, the waveform
discriminators and Adam run in fp32, as both trainers build them. Same
weights (``test_torch_audio_step.setup``: every weight random), same
batch.

The rule follows the bf16 codec steps' (``tests/test_torch_vqgan_bf16.py``):
the JAX step is compiled with XLA's excess precision off (bf16 rounds where
the program says) and traced on the port's RVQ picks, whose own picks must
equal the port's except at near ties (``chip_smoke.PICK_GAP``). Each
tensor's spread is what bf16 rounding alone does to it. That file takes it from
the fp32 step on the same picks; here the fp32 step is no yardstick: the
log-magnitude STFT and mel losses of a tanh output rounded to bf16 move by
5% from fp32's, and most gradients by more than their own size. So the
spread is the largest |difference| between two sound bf16 steps of JAX, the
same program compiled with excess precision off and on (one rounds every
bf16 operation, the other keeps fused intermediates in fp32; it also
covers the fp32 reductions that torch sums where XLA sums in bf16). Held:

- the losses within 3e-2·max(1, |ref|), fp32 on both sides;
- Adam's first moments of the codec and, in the GAN step, of the
  discriminators, each tensor elementwise within 3e-2 of its own largest
  |ref| plus 2.5 times its spread, and over a model's tensors the median
  of (largest error / largest |ref|) under 3e-2 (the spread is larger than
  the gradient on many decoder tensors; the median is what a wrong term
  or rate would move everywhere); the readings are printed (run the file
  alone with ``-s``);
- the median |change| of each model's parameters about the learning rate,
  and the parameters fp32;
- the RVQ state after the step (its EMA of the bf16 encoder's fp32
  latents) within 3e-2 of each array's largest |ref|.
The RVQ is initialised with no dead codes, so the step draws nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flocoder_tpu.models import audio_codec as jac
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.training import audio as jaudio
from flocoder_tpu.training import vqgan as jvqgan
from flocoder_torch.models import audio_codec as tac
from flocoder_torch.training import audio as taudio
from flocoder_torch.training.checkpoint import (DAC_PREFIXES, DISC_PREFIXES, load_jax_flat,
                                                to_jax_flat)

from test_torch_audio_codec import KW
from test_torch_audio_step import LR, setup, waves
from test_torch_vqgan_bf16 import XLA_OPTIONS, _jax_picks
from test_torch_vqgan_step import _jax_moments, _moments


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _initialised(s):
    """``setup()`` with the RVQ initialised: codebooks at the latents'
    spread, EMA counts of 4–30 (no dead code)."""
    rng = np.random.default_rng(7)
    codec = s["codec"]
    L, K, D = codec.vq.codebooks.shape
    codec.vq.assign_({
        "codebooks": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32) * 0.3),
        "ema_counts": torch.from_numpy(rng.uniform(4, 30, (L, K)).astype(np.float32)),
        "ema_sums": torch.from_numpy(rng.normal(size=(L, K, D)).astype(np.float32)),
        "initted": torch.tensor(True)})
    flat = to_jax_flat(codec, DAC_PREFIXES)
    jp = dict(s["jparams"], vq=JaxRVQState(**{k.split("/")[1]: jnp.asarray(v)
                                              for k, v in flat.items()
                                              if k.startswith("vq/")}))
    return flat, jp


def _port_step(s, flat, phase, x) -> dict:
    codec = load_jax_flat(tac.DACCodec(**KW, dtype=torch.bfloat16), flat, DAC_PREFIXES)
    disc = s["disc"] if phase == "gan" else None
    state = taudio.create_audio_state(codec, disc, LR)
    before = {"codec": to_jax_flat(codec, DAC_PREFIXES)}
    if disc is not None:
        before["disc"] = to_jax_flat(disc, DISC_PREFIXES)
    make = taudio.make_audio_train_step if phase == "recon" else taudio.make_audio_gan_step
    state, aux, idx = make(s["tcfg"])(state, torch.from_numpy(x), torch.Generator())
    return dict(state=state, aux=aux, before=before,
                picks=idx.reshape(-1, idx.shape[-1]).numpy())


def _jax_step(s, jp, phase, x, picks, options) -> dict:
    """JAX's ``phase`` step in bf16 on the port's picks, compiled with
    ``options``."""
    jcodec = jac.DACCodec(**KW, dtype=jnp.bfloat16)
    tx = jaudio.make_audio_optimizer(LR)
    if phase == "recon":
        state0 = jvqgan.create_vqgan_state(jp, tx)
        step = jaudio.make_audio_train_step(jcodec, tx, s["jcfg"], donate=False)
    else:
        _, tx_d = jvqgan.make_vqgan_optimizers(LR, d_lr_scale=1.0)
        state0 = jvqgan.create_vqgan_state(jp, tx, s["jdvars"], tx_d)
        step = jaudio.make_audio_gan_step(jcodec, tx, s["jdisc"], tx_d, s["jcfg"],
                                          donate=False)
    args = (state0, jnp.asarray(x), jax.random.PRNGKey(1))
    own: dict = {}
    with _jax_picks(picks, own):
        lowered = step.lower(*args)
    state, aux, _ = jax.block_until_ready(lowered.compile(compiler_options=options)(*args))
    return dict(state=state, aux=aux, own=own)


def run_bf16_audio_step(phase: str) -> None:
    s = setup()
    flat, jp = _initialised(s)
    x = waves(20)
    port = _port_step(s, flat, phase, x)
    picks = port["picks"]
    ref = _jax_step(s, jp, phase, x, picks, XLA_OPTIONS)
    other = _jax_step(s, jp, phase, x, picks, {})
    levels = sorted(ref["own"])
    assert chip_smoke.worst_pick_gap([picks[:, i] for i in levels],
                                     [ref["own"][i] for i in levels]) < chip_smoke.PICK_GAP

    aux, jaux = port["aux"], ref["aux"]
    assert set(aux) == set(jaux), (sorted(aux), sorted(jaux))
    for k, v in jaux.items():
        assert aux[k].dtype == torch.float32 and v.dtype == jnp.float32, k
        np.testing.assert_allclose(float(aux[k]), float(v),
                                   atol=3e-2 * max(1.0, abs(float(v))), err_msg=k)

    state = port["state"]
    models = [("codec", "opt_g", DAC_PREFIXES, "")]
    if phase == "gan":
        models.append(("disc", "opt_d", DISC_PREFIXES, "params"))
    for what, opt, prefixes, jprefix in models:
        module = getattr(state, what)
        ours = _moments(module, getattr(state, opt), prefixes)
        jmu = _jax_moments(getattr(ref["state"], opt), jprefix)
        jmu2 = _jax_moments(getattr(other["state"], opt), jprefix)
        assert set(jmu) == {k for k in ours if not k.startswith("vq/")}, what
        rel, worst = [], ("", 0.0)
        for name, r in jmu.items():
            r = np.asarray(r, np.float64)
            own = float(np.abs(r).max())
            spread = float(np.abs(np.asarray(jmu2[name], np.float64) - r).max())
            err = float(np.abs(np.asarray(ours[name], np.float64) - r).max())
            if own == 0:
                assert err == 0, (what, name, err)
                continue
            tol = 3e-2 * own + 2.5 * spread
            assert err <= tol, (what, name, err, tol)
            rel.append(err / own)
            worst = max(worst, (name, err / tol), key=lambda w: w[1])
        print(f"{phase} {what} first moments: {len(rel)} tensors, median error "
              f"{np.median(rel):.4f} of the largest |ref|, worst {worst[0]} at "
              f"{worst[1]:.3f} of its tolerance")
        assert np.median(rel) < 3e-2, (what, np.median(rel))
        assert all(p.dtype == torch.float32 for p in module.parameters())
        # where JAX's gradient reaches (a discriminator view whose hinge terms
        # are all clipped has none)
        after = to_jax_flat(module, prefixes)
        change = np.concatenate([
            (np.abs(after[k].astype(np.float64) - port["before"][what][k]) / LR)[
                np.asarray(jmu[k]) != 0] for k in jmu])
        assert 0.5 < np.median(change) < 1.5, f"{what}: median change {np.median(change)}·lr"

    vq = {k: v for k, v in to_jax_flat(state.codec, DAC_PREFIXES).items() if k.startswith("vq/")}
    jvq = ref["state"].params["vq"]
    for name in ("codebooks", "ema_counts", "ema_sums"):
        r = np.asarray(getattr(jvq, name), np.float64)
        np.testing.assert_allclose(vq[f"vq/{name}"], r, rtol=0,
                                   atol=3e-2 * float(np.abs(r).max()), err_msg=name)


def test_bf16_recon_step_matches_jax():
    run_bf16_audio_step("recon")
