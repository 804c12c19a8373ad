"""The DAC codec in bf16 (``codec.bf16`` with ``choice: dac``): the port's
modules at ``dtype=torch.bfloat16`` against the JAX package's at
``dtype=jnp.bfloat16``, op by op (flax ``apply`` without ``jit``: under
``jit`` XLA keeps bf16 intermediates unrounded), on the same weights and
the same numpy inputs.

Weights are random (``test_torch_audio_codec.randomize``: the zero-init
residual convolutions and ``log_alpha`` too) and fp32 in both packages, as
flax keeps them; the compute is bf16. Held, each tensor against its own
largest |ref| (the bf16 codecs' rule, ``tests/test_torch_codec_bf16.py``):

- one layer (Snake, a ``SAME`` convolution with a stride and an even
  kernel, a dilated one, a transposed convolution with strides 2 and 4):
  its output dtype is bf16 as JAX's, and each element is within two bf16
  spacings of JAX's (``_spacings``; one rounding of a product that both
  sides sum in fp32, one of the bias add, and Snake's four roundings seldom
  reach the second);
- the residual unit within 1e-2 of the largest |ref|;
- the encoder's fp32 latents and the decoder's fp32 waveforms within 1e-2
  of the largest |ref| (on this box they agree bit for bit; a dozen layers
  of bf16 roundings may part wherever one upstream value rounds the other
  way), while the bf16 encoder lies at least 1e-4 of it from the fp32 one;
- ``quantize`` of the bf16 encoder's latents: the picks equal JAX's on
  JAX's latents wherever the two nearest codes are not a near tie (a
  relative gap below ``chip_smoke.PICK_GAP``), and z_q within 1e-5 where
  the picks agree (fp32 arithmetic on both sides);
- ``evaluate_model_audio`` with a bf16 codec: the metrics within 3e-2 of
  JAX's, the WAVs it writes read back;
- ``chip_smoke.bf16_ops``, the card's op-by-op hold of the bf16 codec, on
  two CPU codecs: equal ones read 0 on every op, and a convolution that
  rounds otherwise moves over 10% of its elements (the card's gate is 5%).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import chip_smoke
from flocoder_tpu import evaluation as jeval
from flocoder_tpu.models import audio_codec as jac
from flocoder_torch import evaluation as teval
from flocoder_torch.models import audio_codec as tac
from flocoder_torch.training.checkpoint import DAC_PREFIXES, load_jax_flat, to_jax_flat

from test_torch_audio_codec import KW, jax_params, make_codec, randomize

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spacings(ours, ref) -> float:
    """The largest |ours − ref| in bf16 spacings of each reference element
    (the spacing of the larger of |ref| and the smallest normal)."""
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    ours = ours.detach().float().numpy().astype(np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    spacing = np.spacing(np.maximum(np.abs(ref), 2.0 ** -126).astype(np.float32)) * 2.0 ** 16
    return float((np.abs(ours - ref) / spacing).max())


def _rel(ours, ref) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    ours = ours.detach().float().numpy().astype(np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _ncl(x_nlc: np.ndarray, dtype=BF16) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nlc.transpose(0, 2, 1))).to(dtype)


def _nlc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 1)


def _acts(seed, b=2, t=64, c=8) -> np.ndarray:
    """bf16-exact activations (B, T, C)."""
    x = np.random.default_rng(seed).normal(size=(b, t, c)).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _conv_params(conv) -> dict:
    return {"kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 1, 0)),
            "bias": jnp.asarray(conv.bias.detach().numpy())}


def test_snake_in_bf16_matches_jax():
    snake = randomize(tac.Snake(8), 0)
    x = _acts(1)
    ours = snake(_ncl(x))
    ref = jac.Snake().apply({"params": {"log_alpha": jnp.asarray(snake.log_alpha.detach())}},
                            jnp.asarray(x, jnp.bfloat16))
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert _spacings(_nlc(ours), ref) <= 2


@pytest.mark.parametrize("k,s,d,t", [(4, 2, 1, 64), (8, 4, 1, 61), (7, 1, 3, 64), (3, 1, 1, 33)])
def test_conv1d_in_bf16_matches_jax(k, s, d, t):
    """flax ``nn.Conv(padding="SAME", dtype=bfloat16)``: input, kernel and
    bias cast to bf16, the bias added after the product rounds; a bf16 and an
    fp32 input (the encoder's first convolution takes the fp32 waveform)."""
    conv = randomize(tac.Conv1d(8, 6, k, s, d, dtype=BF16), 2)
    ref_mod = nn.Conv(6, (k,), strides=(s,), kernel_dilation=(d,), padding="SAME",
                      dtype=jnp.bfloat16)
    for x in (_acts(3, t=t), np.random.default_rng(4).normal(size=(2, t, 8)).astype(np.float32)):
        ours = conv(_ncl(x, torch.float32 if x.dtype == np.float32 else BF16))
        ref = ref_mod.apply({"params": _conv_params(conv)}, jnp.asarray(x))
        assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
        assert _spacings(_nlc(ours), ref) <= 2, (k, s, d, t)


@pytest.mark.parametrize("s,t", [(2, 32), (4, 17), (3, 10)])
def test_conv_transpose1d_in_bf16_matches_jax(s, t):
    """flax ``nn.ConvTranspose(padding="SAME", dtype=bfloat16)`` (the kernel
    not flipped), checked apart from the plain convolution's rounding."""
    conv = randomize(tac.ConvTranspose1d(8, 4, 2 * s, s, dtype=BF16), 5)
    x = _acts(6, t=t)
    ours = conv(_ncl(x))
    ref = nn.ConvTranspose(4, (2 * s,), strides=(s,), padding="SAME",
                           dtype=jnp.bfloat16).apply({"params": _conv_params(conv)},
                                                     jnp.asarray(x, jnp.bfloat16))
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16 and ours.shape[-1] == t * s
    assert _spacings(_nlc(ours), ref) <= 2, (s, t)


def test_residual_unit_in_bf16_matches_jax():
    unit = randomize(tac.ResidualUnit1D(8, 3, dtype=BF16), 7)
    x = _acts(8)
    params = {"Snake_0": {"log_alpha": jnp.asarray(unit.Snake_0.log_alpha.detach())},
              "Snake_1": {"log_alpha": jnp.asarray(unit.Snake_1.log_alpha.detach())},
              "Conv_0": _conv_params(unit.Conv_0), "Conv_1": _conv_params(unit.Conv_1)}
    ours = unit(_ncl(x))
    ref = jac.ResidualUnit1D(8, dilation=3, dtype=jnp.bfloat16).apply(
        {"params": params}, jnp.asarray(x, jnp.bfloat16))
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    assert _rel(_nlc(ours), ref) < 1e-2


def _bf16_pair(seed: int = 0):
    """The tiny codec at fp32 and its bf16 twin on the same weights, and
    JAX's bf16 codec with its parameter tree."""
    codec = make_codec(seed)
    bf16 = load_jax_flat(tac.DACCodec(**KW, dtype=BF16), to_jax_flat(codec, DAC_PREFIXES),
                         DAC_PREFIXES)
    return codec, bf16, jac.DACCodec(**KW, dtype=jnp.bfloat16), jax_params(codec)


def test_encoder_decoder_and_quantize_in_bf16_match_jax():
    codec, bf16, jc, jp = _bf16_pair()
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    x = np.random.default_rng(9).uniform(-0.9, 0.9, size=(2, 512, 1)).astype(np.float32)
    with torch.no_grad():
        z = bf16.encode(torch.from_numpy(x))
        z32 = codec.encode(torch.from_numpy(x))
    zj = jc.encode(jp, jnp.asarray(x))
    assert z.dtype == torch.float32 and zj.dtype == jnp.float32
    assert _rel(z, zj) < 1e-2
    assert 1e-4 < _rel(z, z32.numpy())          # the bf16 codec is not the fp32 one

    with torch.no_grad():
        zq, idx, loss, _ = bf16.quantize(z)
    zq_j, idx_j, loss_j, _ = jc.quantize(jp, zj)
    idx, idx_j = idx.numpy(), np.asarray(idx_j)
    # where the two packages' latents pick differently, the two nearest codes
    # are a near tie for one of them
    cb = codec.vq.codebooks.double().numpy()
    for lvl in range(idx.shape[-1]):
        diff = idx[..., lvl] != idx_j[..., lvl]
        assert diff.mean() < 0.1, lvl
        if lvl == 0 and diff.any():
            r = z.double().numpy()[diff]
            gap = np.abs(((r - cb[0][idx[..., 0][diff]]) ** 2).sum(-1)
                         - ((r - cb[0][idx_j[..., 0][diff]]) ** 2).sum(-1))
            assert (gap / (r ** 2).sum(-1) < chip_smoke.PICK_GAP).all()
    same = (idx == idx_j).all(-1)
    np.testing.assert_allclose(zq.numpy()[same], np.asarray(zq_j)[same], rtol=0, atol=1e-5)
    assert zq.dtype == torch.float32 and np.isfinite(float(loss))

    latents = np.random.default_rng(10).normal(size=(2, 16, 4)).astype(np.float32)
    with torch.no_grad():
        wave = bf16.decode(torch.from_numpy(latents))
        folded = bf16.decode(torch.from_numpy(latents.reshape(2, 4, 4, 4)))
    wave_j = jc.decode(jp, jnp.asarray(latents))
    assert wave.dtype == torch.float32 and wave_j.dtype == jnp.float32
    assert wave.shape == (2, 16 * bf16.hop, 1) and torch.equal(wave, folded)
    assert _rel(wave, wave_j) < 1e-2


def test_evaluate_model_audio_with_a_bf16_codec_matches_jax(tmp_path, monkeypatch):
    """The flow evaluation of an audio run whose codec is bf16: the same
    velocity field (a fixed linear map of x and t, in both packages) and the
    same start noise (handed to both samplers' one draw; Euler draws nothing
    else); the metrics within 3e-2 of JAX's and the same WAVs written."""
    _, bf16, jc, jp = _bf16_pair(3)
    target = np.random.default_rng(11).normal(size=(4, 8, 8, 4)).astype(np.float32)
    noise = np.random.default_rng(12).normal(size=(4, 8, 8, 4)).astype(np.float32)

    def field(x, t, cond):
        return -0.5 * x + 1e-4 * t.reshape(-1, 1, 1, 1)

    randn, normal = torch.randn, jax.random.normal
    monkeypatch.setattr(torch, "randn", lambda size, *a, **k: torch.from_numpy(noise).clone()
                        if tuple(size) == noise.shape else randn(size, *a, **k))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), *a, **k: jnp.asarray(noise)
                        if tuple(shape) == noise.shape else normal(key, shape, *a, **k))
    ours = teval.evaluate_model_audio(field, bf16, 1, torch.from_numpy(target),
                                      torch.Generator().manual_seed(0), method="euler",
                                      n_steps=3, output_dir=str(tmp_path / "t"))
    ref = jeval.evaluate_model_audio(field, jc, jp, 1, jnp.asarray(target),
                                     jax.random.PRNGKey(0), method="euler", n_steps=3,
                                     use_wandb=False, output_dir=str(tmp_path / "j"))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=3e-2 * max(1.0, abs(v)), err_msg=k)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))


@pytest.mark.parametrize("name, fault", [("encoder.Conv_0", "input unrounded"),
                                         ("encoder.ResidualUnit1D_0.Conv_0", "fp32 compute")])
def test_chip_smoke_op_hold_tells_a_misrounded_convolution(name, fault, monkeypatch):
    """``chip_smoke.bf16_ops`` feeds each op of one codec the other's input to
    it. With one convolution of the first codec faulty (its input left
    unrounded, or its weight and bias in fp32 with one rounding of the
    result) only that op differs, in over 10% of its elements."""
    _, bf16, _, _ = _bf16_pair()
    other = copy.deepcopy(bf16)
    x = torch.from_numpy(np.random.default_rng(11).uniform(
        -0.9, 0.9, size=(1, 512, 1)).astype(np.float32))
    with torch.no_grad():
        zq = bf16.quantize(bf16.encode(x))[0]
    ops, z, w = chip_smoke.bf16_ops(other, bf16, x, zq)
    assert len(ops) > 20 and all(share == 0 and excess == 0 for _, share, excess in ops)
    with torch.no_grad():
        assert torch.equal(z, bf16.encode(x)) and torch.equal(w, bf16.decode(zq))

    conv = dict(other.named_modules())[name]
    narrow = tac._narrow_conv

    def faulty(h):
        if fault == "input unrounded":
            with monkeypatch.context() as m:
                m.setattr(tac, "_narrow_conv", lambda fn, a, b, dt, **kw: narrow(
                    lambda a2, b2, **kw2: fn(a.float(), b2, **kw2), a, b, dt, **kw))
                return tac.Conv1d.forward(conv, h)
        with monkeypatch.context() as m:
            m.setattr(conv, "compute_dtype", None)
            return tac.Conv1d.forward(conv, h.float()).to(BF16)
    conv.forward = faulty
    ops = chip_smoke.bf16_ops(other, bf16, x, zq)[0]
    shares = {n: share for n, share, _ in ops if share > 0}
    assert list(shares) == [name] and shares[name] > 0.1, shares
