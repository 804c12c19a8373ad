"""The port's DAC audio codec (flocoder_torch.models.audio_codec) against the
JAX package's on the same weights and the same numpy waveforms.

Before bridging, every parameter is drawn at random, the zero-initialised
1×1 output convolutions of the residual units and Snake's ``log_alpha``
included (with zero-init the residual chain is the identity, and parity
would prove nothing); kernels at 0.5/√fan_in, which keeps the decoder's
tanh out of saturation. The weights cross through the bridge
(``to_jax_flat``), whose keys and shapes are checked against flax's own
tree (``jax.eval_shape`` of ``init``), at a tiny size and at
``audio_dac.yaml``'s widths.

Held: flax's ``SAME`` convolutions (strides 2 and 4 with even kernels,
asymmetric pads; dilations; groups) and ``ConvTranspose`` (strides 2, 3
and 4, odd and even lengths) layer by layer; Snake; the encoder at odd and
even lengths, the decoder on (B, T', D) and folded (B, H, W, D) latents,
``quantize`` and ``forward``. Tolerance (fp32, ``highest`` precision):
1e-5·max(1, |ref|); the RVQ picks equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.models import audio_codec as jac
from flocoder_tpu.models.codecs import setup_codec as jsetup_codec
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch.config import load_config
from flocoder_torch.models import audio_codec as tac
from flocoder_torch.models.codecs import setup_codec
from flocoder_torch.training.checkpoint import DAC_PREFIXES, to_jax_flat

KW = dict(sample_rate=16000, strides=(2, 4), base_channels=4, vq_embedding_dim=4,
          codebook_levels=2, vq_num_embeddings=16, commitment_weight=0.25)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def randomize(module, seed: int, scale: float = 0.5):
    """Every parameter at random: kernels N(0, scale²/fan_in), vectors
    (biases, ``log_alpha``) N(0, 0.3²)."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = 0.3 if p.ndim == 1 else scale / np.sqrt(p[0].numel())
            p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32) * std))
    return module


def make_codec(seed: int = 0, **kw) -> tac.DACCodec:
    """A tiny codec with every weight random and an initialised codebook."""
    codec = randomize(tac.DACCodec(**{**KW, **kw}).init(torch.Generator().manual_seed(seed)),
                      seed + 1)
    rng = np.random.default_rng(seed + 2)
    with torch.no_grad():
        codec.vq.codebooks.copy_(torch.from_numpy(
            rng.normal(size=tuple(codec.vq.codebooks.shape)).astype(np.float32)))
        codec.vq.ema_counts.fill_(5.0)
        codec.vq.initted.fill_(True)
    return codec


def flax_paths(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_params(codec: tac.DACCodec) -> dict:
    """The JAX parameter tree of the port codec's weights (bridge)."""
    tree = unflatten_tree({k: jnp.asarray(v) for k, v in to_jax_flat(codec, DAC_PREFIXES).items()})
    return {"encoder": tree["encoder"], "decoder": tree["decoder"],
            "vq": JaxRVQState(**tree["vq"])}


def _close(ours, ref, what=""):
    ref = np.asarray(ref, np.float64)
    ours = np.asarray(ours.detach() if isinstance(ours, torch.Tensor) else ours, np.float64)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-5 * max(1.0, float(np.abs(ref).max())), err_msg=what)


def _waves(seed, b, t):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, size=(b, t, 1)).astype(np.float32)


def test_bridge_keys_are_flax_names():
    codec = make_codec()
    jc = jac.DACCodec(**KW)
    shapes = flax_paths(jax.eval_shape(jc.init, jax.random.PRNGKey(0), jnp.zeros((1, 128, 1))))
    assert {k: v.shape for k, v in to_jax_flat(codec, DAC_PREFIXES).items()} == shapes


def test_audio_dac_widths_and_parameter_counts():
    """``audio_dac.yaml`` as composed through both factories: the same tree
    (3,493,672 encoder, 3,510,049 decoder and 34,817 RVQ state values) and
    16×16×8 latents for a 32,768-sample crop."""
    cfg = load_config("audio_dac", "configs")
    codec = setup_codec(cfg)
    jc = jsetup_codec(jload_config("audio_dac", "configs"))
    shapes = flax_paths(jax.eval_shape(jc.init, jax.random.PRNGKey(0), jnp.zeros((1, 32768, 1))))
    flat = to_jax_flat(codec, DAC_PREFIXES)
    assert {k: v.shape for k, v in flat.items()} == shapes
    count = lambda head: sum(v.size for k, v in flat.items() if k.startswith(head))  # noqa: E731
    assert (count("encoder/"), count("decoder/"), count("vq/")) == (3493672, 3510049, 34817)
    assert codec.latent_shape(32768) == jc.latent_shape(32768) == (16, 16, 8)
    assert codec.hop == jc.hop == 128 and codec.is_audio and codec.in_channels == 1


@pytest.mark.parametrize("k,s,d,groups,t", [
    (4, 2, 1, 1, 63), (4, 2, 1, 1, 64), (8, 4, 1, 1, 61), (8, 4, 1, 1, 64),
    (7, 1, 3, 1, 30), (7, 1, 9, 1, 31), (41, 4, 1, 4, 157), (3, 1, 1, 1, 5)])
def test_conv_same_matches_flax(k, s, d, groups, t):
    cin, cout = 8, 12
    conv = randomize(tac.Conv1d(cin, cout, k, s, d, groups), 3 * k + s, scale=1.0)
    jconv = nn.Conv(cout, (k,), strides=(s,), kernel_dilation=(d,), padding="SAME",
                    feature_group_count=groups)
    params = {"params": {"kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 1, 0)),
                         "bias": jnp.asarray(conv.bias.detach().numpy())}}
    x = np.random.default_rng(t).normal(size=(2, t, cin)).astype(np.float32)
    ref = jconv.apply(params, x)
    ours = conv(torch.from_numpy(x).permute(0, 2, 1)).permute(0, 2, 1)
    assert ours.shape[1] == -(-t // s)
    _close(ours, ref, f"conv k{k} s{s} d{d} g{groups} t{t}")


@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("t", [7, 8])
@pytest.mark.parametrize("k_of_s", [2, 1])
def test_conv_transpose_matches_flax(s, t, k_of_s):
    """Kernel 2s (the decoder's) and s (lax's other padding branch)."""
    k, cin, cout = k_of_s * s, 6, 5
    conv = randomize(tac.ConvTranspose1d(cin, cout, k, s), 10 * s + t, scale=1.0)
    jconv = nn.ConvTranspose(cout, (k,), strides=(s,), padding="SAME")
    params = {"params": {"kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 1, 0)),
                         "bias": jnp.asarray(conv.bias.detach().numpy())}}
    x = np.random.default_rng(t).normal(size=(2, t, cin)).astype(np.float32)
    ref = jconv.apply(params, x)
    ours = conv(torch.from_numpy(x).permute(0, 2, 1)).permute(0, 2, 1)
    assert ours.shape[1] == t * s
    _close(ours, ref, f"transpose k{k} s{s} t{t}")


def test_snake_matches_jax():
    snake = randomize(tac.Snake(6), 4)
    x = np.random.default_rng(5).normal(size=(3, 17, 6)).astype(np.float32) * 3
    ref = jac.Snake().apply({"params": {"log_alpha": jnp.asarray(snake.log_alpha.detach().numpy())}},
                            x)
    _close(snake(torch.from_numpy(x).permute(0, 2, 1)).permute(0, 2, 1), ref)


@pytest.mark.parametrize("t", [128, 203])
def test_encoder_decoder_match_jax(t):
    """Encoder at an even and an odd length (asymmetric strided pads), the
    decoder on the latents at the resulting even and odd lengths."""
    codec = make_codec()
    jc, jp = jac.DACCodec(**KW), jax_params(codec)
    x = _waves(t, 2, t)
    z_ref = jax.jit(lambda v: jc.encode(jp, v))(x)
    z = codec.encode(torch.from_numpy(x))
    assert z.dtype == torch.float32
    _close(z, z_ref, "encode")
    _close(codec.encode(torch.from_numpy(x[..., 0])), z_ref, "encode (B, T)")
    y_ref = jax.jit(lambda v: jc.decode(jp, v))(z_ref)
    y = codec.decode(torch.from_numpy(np.array(z_ref)))
    assert y.shape == (2, z.shape[1] * codec.hop, 1) and y.dtype == torch.float32
    _close(y, y_ref, "decode")


def test_folded_decode_quantize_forward_match_jax():
    codec = make_codec()
    jc, jp = jac.DACCodec(**KW), jax_params(codec)
    x = _waves(7, 2, 16 * 8)
    z = np.array(jax.jit(lambda v: jc.encode(jp, v))(x))
    folded = jac.fold_latents(z)
    assert np.array_equal(tac.fold_latents(torch.from_numpy(z)).numpy(), np.asarray(folded))
    assert np.array_equal(tac.unfold_latents(torch.from_numpy(np.array(folded))).numpy(), z)
    _close(codec.decode(torch.from_numpy(np.array(folded))),
           jax.jit(lambda v: jc.decode(jp, v))(folded), "decode folded")
    for lat in (z, np.array(folded)):          # sequences and folded images
        zq_ref, idx_ref, loss_ref, _ = jax.jit(lambda v: jc.quantize(jp, v))(lat)
        zq, idx, loss, new = codec.quantize(torch.from_numpy(lat))
        assert np.array_equal(idx.numpy(), np.asarray(idx_ref))
        _close(zq, zq_ref, "z_q")
        _close(loss, loss_ref, "commit")
        assert new is not None and bool(new["initted"])
    recon_ref, commit_ref, idx_ref, _ = jax.jit(lambda v: jc.forward(jp, v))(x)
    recon, commit, idx, _ = codec(torch.from_numpy(x))
    assert np.array_equal(idx.numpy(), np.asarray(idx_ref))
    _close(recon, recon_ref, "forward")
    _close(commit, commit_ref, "forward commit")


def test_latent_shape_and_fold_refuse_non_squares():
    codec = tac.DACCodec(**KW)
    assert codec.latent_shape(8 * 64) == (8, 8, 4)
    with pytest.raises(ValueError, match="perfect square"):
        codec.latent_shape(8 * 60)
    with pytest.raises(ValueError, match="perfect square"):
        tac.fold_latents(torch.zeros(1, 60, 4))


def test_setup_codec_builds_dac_and_refuses_bf16():
    """The factory builds the DAC codec; in bf16 (``codec.bf16``, and the
    ``dtype=`` of serving, which wins) as the JAX factory does: the
    convolutions compute in bf16 over fp32 parameters. (The name is from
    when bf16 raised.)"""
    tiny = ["codec.strides=[2,4]", "codec.base_channels=4"]
    cfg = load_config("audio_dac", "configs", tiny)
    codec = setup_codec(cfg)
    assert isinstance(codec, tac.DACCodec) and codec.strides == (2, 4)
    assert codec.sample_rate == 16000 and codec.vq.codebooks.shape == (4, 512, 8)
    assert codec.dtype == torch.float32 and codec.encoder.Conv_0.compute_dtype is None
    bf16_cfg = ["+codec.bf16=true", *tiny]
    for built, jbuilt in (
            (setup_codec(load_config("audio_dac", "configs", bf16_cfg)),
             jsetup_codec(jload_config("audio_dac", "configs", bf16_cfg))),
            (setup_codec(cfg, dtype=torch.bfloat16),
             jsetup_codec(jload_config("audio_dac", "configs", tiny), dtype=jnp.bfloat16))):
        assert built.dtype == torch.bfloat16 and jbuilt.encoder.dtype == jnp.bfloat16
        convs = [m for m in built.modules() if isinstance(m, tac.Conv1d)]
        assert convs and all(m.compute_dtype == torch.bfloat16 for m in convs)
        assert all(p.dtype == torch.float32 for p in built.parameters())
    assert setup_codec(load_config("audio_dac", "configs", bf16_cfg),
                       dtype=torch.float32).dtype == torch.float32
