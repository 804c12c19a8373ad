"""The port's VQGAN codec in bf16 (``setup_codec`` with ``codec.bf16``),
alone and with the W8A8 int8 encoder or decoder (``codec.quant_encode`` /
``quant_decode``), against the JAX codec at the same flags, on the CPU at
small widths (hidden 32, two downsamples, 16² images); the SD VAE's are in
``test_torch_sd_vae_bf16.py``. The weights are
the port's seeded init plus noise on every parameter, a fifth of the
parameter's spread (0.02 where the init is constant; NATTEN's gamma set
near 0.5, so the attention counts), carried to JAX through the
weight bridge and JAX's ``load_into_tree`` (which rounds the bf16 gamma, as
the port's loader does). JAX runs op by op (no ``jit``): every bf16
operation rounds, as torch's do (the port's bf16 SiLU rounds at each step
as ``jax.nn.silu`` does), and the int8 codes are the port's.

Tolerance: 3e-2 of the largest |ref|, for bf16 and int8 alike. Single bf16
roundings (a 3×3 convolution's sum in another order, the banded NATTEN)
grow through the blocks; the VQGAN decoder lands near 1e-2, the encoder
near 5e-3. The int8 paths come out closer, since an exact integer product
takes the summation order out. Under ``jit`` the JAX codecs themselves
move by up to 3e-2 (bf16) and 7e-2 (int8: XLA's excess precision moves
codes a step) from their op-by-op results, so the comparison is op by op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.training.checkpoint import _path_part, unflatten_tree
from flocoder_torch.config import load_config
from flocoder_torch.generate_samples import CONFIG_DIR
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models.sd_vae import SDVAE
from flocoder_torch.ops import quant as tquant
from flocoder_torch.training.checkpoint import (VQVAE_PREFIXES, _entries,
                                                load_jax_flat, save_checkpoint, to_jax_flat)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VQ = dict(in_channels=3, hidden_channels=32, num_downsamples=2, internal_dim=32,
          vq_embedding_dim=4, codebook_levels=3, vq_num_embeddings=16)


def _perturbed_flat(codec, prefixes, seed):
    """The fp32 codec's seeded weights plus noise, as a flat JAX tree."""
    codec.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in codec.named_parameters():
            noise = rng.normal(size=tuple(p.shape)).astype(np.float32)
            scale = 0.2 * float(p.std()) if p.numel() > 1 and float(p.std()) > 0 else 0.02
            p.add_(torch.from_numpy(scale * noise))
            if name.endswith("gamma"):
                p.add_(0.5)
    return to_jax_flat(codec, prefixes)


def _jax_params(template, flat):
    """``flat`` restored into the structure and dtypes of ``template`` (an
    abstract tree, ``jax.eval_shape`` of ``init``), each array cast to its
    leaf's dtype as ``load_into_tree`` casts (a bf16 gamma), strictly."""
    leaves = {"/".join(_path_part(p) for p in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(template)[0]}
    assert set(leaves) == set(flat)
    return unflatten_tree({k: jnp.asarray(np.asarray(flat[k]).astype(leaf.dtype))
                           for k, leaf in leaves.items()})


def _close(ours, ref, rel):
    ours = ours.float().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


@pytest.mark.parametrize("quant", ["", "encode", "decode"])
def test_vqgan_codec_in_bf16_matches_jax(quant):
    flat = _perturbed_flat(tcodecs.VQVAE(**VQ), VQVAE_PREFIXES, 3)
    kw = dict(quant_encode=quant == "encode", quant_decode=quant == "decode")
    tc = tcodecs.VQVAE(**VQ, dtype=torch.bfloat16, **kw)
    load_jax_flat(tc, flat, VQVAE_PREFIXES)
    tc.eval()
    jc = jcodecs.VQVAE(**VQ, dtype=jnp.bfloat16, **kw)
    x = np.random.default_rng(4).uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    template = jax.eval_shape(jc.init, jax.random.PRNGKey(0), jnp.asarray(x))
    assert any(leaf.dtype == jnp.bfloat16 for leaf in jax.tree_util.tree_leaves(
        template["encoder"]))                                           # the gammas
    params = _jax_params({"encoder": template["encoder"], "decoder": template["decoder"]},
                         {k: v for k, v in flat.items() if not k.startswith("vq/")})
    params["vq"] = JaxRVQState(**{k.split("/")[1]: jnp.asarray(v) for k, v in flat.items()
                                  if k.startswith("vq/")})
    tquant.int_mm_calls.launches = 0
    with torch.inference_mode():
        z = tc.encode(torch.from_numpy(x))
        zin = np.random.default_rng(5).normal(size=z.shape).astype(np.float32)
        y = tc.decode(torch.from_numpy(zin))
        zq = tc.quantize(z)[0]              # the RVQ keeps the latents' dtype
    assert zq.dtype == torch.bfloat16 and zq.shape == z.shape and torch.isfinite(zq).all()
    z_ref = jc.encode(params, jnp.asarray(x))
    y_ref = jc.decode(params, jnp.asarray(zin))
    assert z.dtype == y.dtype == torch.bfloat16 and z_ref.dtype == jnp.bfloat16
    _close(z, z_ref, 3e-2)
    _close(y, y_ref, 3e-2)
    gammas = [m.gamma for m in tc.modules() if isinstance(m, tcodecs.NATTENBlock)]
    assert gammas and all(g.dtype == torch.bfloat16 for g in gammas)
    assert tquant.int_mm_calls.launches == 0            # the CPU runs the twin


def test_setup_codec_dtype_and_quant_flags():
    """bf16 if and only if codec.bf16 (never flow.bf16), unless dtype= says
    otherwise; the quant flags route the JAX package's sites to QuantConv and
    leave the heads plain."""
    def build(*ov, **kw):
        return tcodecs.setup_codec(load_config("smoke_vqgan", CONFIG_DIR, list(ov)), **kw)
    assert build().dtype == torch.float32
    assert build("+flow.bf16=true").dtype == torch.float32
    assert build("+codec.bf16=true").dtype == torch.bfloat16
    assert build("+codec.bf16=true", dtype=torch.float32).dtype == torch.float32
    c = build("+codec.quant_encode=int8", "+codec.quant_decode=int8")
    assert isinstance(c.encoder.Conv_0, tquant.QuantConv)
    assert not isinstance(c.encoder.Conv_1, tquant.QuantConv)      # the compression head
    assert isinstance(c.decoder.EncDecResidualBlock_0.Conv_0, tquant.QuantConv)
    head = [m for m in c.decoder.modules() if isinstance(m, torch.nn.Conv2d)][-1]
    assert head.out_channels == 3 and not isinstance(head, tquant.QuantConv)
    assert not any(isinstance(m, tquant.QuantConv)
                   for m in build("+codec.quant_encode=int8", quant_decode=False).decoder.modules())
    sd = tcodecs.setup_codec(load_config("flowers_sd", CONFIG_DIR, ["+codec.bf16=true",
                                                                  "+codec.quant_decode=int8"]))
    assert isinstance(sd, SDVAE) and sd.dtype == torch.bfloat16
    assert isinstance(sd.decoder._Resnet_0.Conv_0, tquant.QuantConv)
    assert not isinstance(sd.decoder.head[0], tquant.QuantConv)


def test_natten_gamma_is_bf16_and_loads_from_an_fp32_checkpoint(tmp_path):
    """A bf16 codec holds NATTEN's gamma in bf16 (every other parameter
    fp32); loading an fp32 checkpoint rounds it to nearest even, and saving
    a bf16 codec writes it widened to fp32."""
    fp32 = tcodecs.VQVAE(**VQ)
    flat = _perturbed_flat(fp32, VQVAE_PREFIXES, 7)
    path = save_checkpoint(flat, 1, ckpt_dir=str(tmp_path), prefix="vqgan_")
    cfg = load_config("smoke_vqgan", CONFIG_DIR, ["+codec.bf16=true", "codec.hidden_channels=32",
                                                   "codec.num_downsamples=2",
                                                   "codec.internal_dim=32",
                                                   "codec.codebook_levels=3",
                                                   "codec.vq_num_embeddings=16"])
    tc = tcodecs.setup_codec(cfg)
    assert tcodecs.load_codec_weights(tc, path) == [path]
    for (name, p), (_, q) in zip(tc.named_parameters(), fp32.named_parameters()):
        if name.endswith("gamma"):
            assert p.dtype == torch.bfloat16 and q.dtype == torch.float32
            assert torch.equal(p, q.detach().to(torch.bfloat16))
            assert not torch.equal(p.float(), q.detach())
        else:
            assert p.dtype == torch.float32 and torch.equal(p, q)
    back = to_jax_flat(tc, VQVAE_PREFIXES)
    g = [k for k in back if k.endswith("gamma")]
    assert g and all(back[k].dtype == np.float32 for k in g)
    # bf16 arrays of the JAX package (ml_dtypes) load by their bits
    jflat = dict(flat)
    for k in g:
        jflat[k] = np.asarray(jnp.asarray(flat[k], jnp.bfloat16))
    load_jax_flat(tc, jflat, VQVAE_PREFIXES)
    for tkey, (jkey, _) in _entries(tc, VQVAE_PREFIXES).items():
        if jkey in g:
            assert torch.equal(tc.state_dict()[tkey],
                               torch.from_numpy(flat[jkey]).to(torch.bfloat16))
