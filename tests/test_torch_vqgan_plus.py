"""The port's VQGAN+ codec (``flocoder_torch/models/vqgan_plus.py``) against
the JAX package's ``flocoder_tpu/models/vqgan_plus.py`` on the CPU, on the
same numpy-seeded weights (the port's seeded init plus noise on every
parameter, a fifth of its spread, 0.02 where the init is constant) carried
to JAX through the weight bridge, which must map the JAX tree strictly.

- fp32, at ``num_downsamples`` 3 and 4: a residual block, the encoder, the
  decoder and ``forward`` (reconstruction, commitment loss, RVQ indices)
  within 1e-4·max(1, |ref|); the indices equal.
- bf16 and int8: ``test_torch_vqgan_plus_bf16.py``.
- ``jax.image.resize(..., "nearest")`` at exactly 2× equals the port's
  ``upsample_nearest_2x`` and a ``repeat_interleave`` bit for bit.
- ``multipliers_for`` and ``setup_codec`` with ``choice: vqgan_plus`` (the
  quant flags and the sites they route, as ``tests/test_quant.py`` checks
  the JAX factory).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.config import config_from_dict as jconfig_from_dict
from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.models import vqgan_plus as jvp
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.training.checkpoint import _path_part, flatten_tree, unflatten_tree
from flocoder_torch.config import Config
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models import vqgan_plus as tvp
from flocoder_torch.models.layers import init_params
from flocoder_torch.ops import quant as tquant
from flocoder_torch.training.checkpoint import VQVAE_PREFIXES, load_jax_flat, to_jax_flat


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(num_downsamples=3, hidden=16, internal=32):
    return dict(in_channels=3, hidden_channels=hidden, num_downsamples=num_downsamples,
                internal_dim=internal, vq_embedding_dim=4, codebook_levels=2,
                vq_num_embeddings=16)


def _perturb(module, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in module.parameters():
            std = float(p.std()) if p.numel() > 1 else 0.0
            scale = 0.2 * std if std > 0 else 0.02
            p.add_(torch.from_numpy(scale * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    return module


def _flat(kw, seed):
    codec = tvp.VQGANPlus(**kw)
    codec.init(torch.Generator().manual_seed(seed))
    return to_jax_flat(_perturb(codec, seed), VQVAE_PREFIXES)


def _jax_params(jc, flat, x):
    """``flat`` as the JAX codec's params, after checking that its keys are
    exactly those of the JAX tree (``jax.eval_shape`` of ``init``)."""
    tmpl = jax.eval_shape(jc.init, jax.random.PRNGKey(0), jnp.asarray(x))
    heads = {"encoder": tmpl["encoder"], "decoder": tmpl["decoder"]}
    leaves = {"/".join(_path_part(p) for p in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(heads)[0]}
    net = {k: v for k, v in flat.items() if not k.startswith("vq/")}
    assert set(leaves) == set(net)
    params = unflatten_tree({k: jnp.asarray(np.asarray(net[k]).astype(leaf.dtype))
                             for k, leaf in leaves.items()})
    params["vq"] = JaxRVQState(**{k.split("/")[1]: jnp.asarray(v) for k, v in flat.items()
                                  if k.startswith("vq/")})
    return params


def _close(ours, ref, atol_rel, floor=1.0):
    ours = ours.float().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=atol_rel * max(floor, float(np.abs(ref).max())))


def test_multipliers_for_matches_jax():
    for n in range(1, 8):
        assert tvp.multipliers_for(n) == jvp.multipliers_for(n), n


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_nearest_upsample_equals_jax_resize(dtype):
    x = np.random.default_rng(0).normal(size=(2, 5, 3, 6)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = np.asarray(jax.image.resize(jx, (2, 10, 6, 6), "nearest").astype(jnp.float32))
    t = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).permute(0, 3, 1, 2)
    if dtype == "bfloat16":
        t = t.bfloat16()
    up = tvp.upsample_nearest_2x(t)
    rep = t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    assert up.dtype == t.dtype
    np.testing.assert_array_equal(up.float().permute(0, 2, 3, 1).numpy(), ref)
    assert torch.equal(up, rep)


@pytest.mark.parametrize("stride,c_in", [(2, 16), (1, 16), (1, 32)])
def test_residual_block_matches_jax(stride, c_in):
    blk = tvp.VQGANPlusResidualBlock(c_in, 32, stride)
    init_params(blk, torch.Generator().manual_seed(stride + c_in))
    _perturb(blk, 3)
    flat = to_jax_flat(blk, {"": "params"})
    x = np.random.default_rng(2).normal(size=(2, 8, 8, c_in)).astype(np.float32)
    params = unflatten_tree({k: jnp.asarray(v) for k, v in flat.items()})
    jb = jvp.VQGANPlusResidualBlock(32, stride=stride)
    tmpl = jax.eval_shape(jb.init, jax.random.PRNGKey(0), jnp.asarray(x))
    assert set(flatten_tree(tmpl)) == set(flat)
    ref = jb.apply(params, jnp.asarray(x))
    with torch.no_grad():
        y = blk(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(y, ref, 1e-4)


@pytest.mark.parametrize("num_downsamples", [3, 4])
def test_vqgan_plus_fp32_matches_jax(num_downsamples):
    kw = _kw(num_downsamples)
    flat = _flat(kw, num_downsamples)
    tc = tvp.VQGANPlus(**kw)
    load_jax_flat(tc, flat, VQVAE_PREFIXES)
    tc.eval()
    jc = jvp.VQGANPlus(**kw)
    x = np.random.default_rng(4).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    params = _jax_params(jc, flat, x)
    s = 32 // 2 ** num_downsamples
    assert tc.latent_shape(32) == jc.latent_shape(32) == (s, s, 4)
    zin = np.random.default_rng(5).normal(size=(2, s, s, 4)).astype(np.float32)
    z_ref = jax.jit(jc.encode)(params, jnp.asarray(x))
    y_ref = jax.jit(jc.decode)(params, jnp.asarray(zin))
    recon_ref, commit_ref, idx_ref, _ = jax.jit(jc.forward)(params, jnp.asarray(x))
    with torch.no_grad():
        z = tc.encode(torch.from_numpy(x))
        y = tc.decode(torch.from_numpy(zin))
        recon, commit, idx, _ = tc(torch.from_numpy(x))
    _close(z, z_ref, 1e-4)
    _close(y, y_ref, 1e-4)
    _close(recon, recon_ref, 1e-4)
    _close(commit, commit_ref, 1e-4)
    assert idx.shape == (2, s, s, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))


def _build(**codec):
    return tcodecs.setup_codec(Config({"image_size": 32, "codec": {
        "choice": "vqgan_plus", "hidden_channels": 32, **codec}}))


def test_setup_codec_builds_vqgan_plus():
    plain = _build()
    assert isinstance(plain, tvp.VQGANPlus) and plain.dtype == torch.float32
    assert not any(isinstance(m, tquant.QuantConv) for m in plain.modules())
    jplain = jcodecs.setup_codec(jconfig_from_dict({"image_size": 32, "codec": {
        "choice": "vqgan_plus", "hidden_channels": 32}}))
    assert isinstance(jplain, jvp.VQGANPlus)
    for key in ("num_downsamples", "codebook_levels", "vq_num_embeddings",
                "vq_embedding_dim", "commitment_weight", "in_channels"):
        assert getattr(plain, key) == getattr(jplain, key), key
    assert plain.latent_shape(32) == jplain.latent_shape(32)
    q = _build(quant_encode="int8", quant_decode="int8")
    enc, dec = q.encoder, q.decoder
    for site in (enc.Conv_0, enc.Conv_1, enc.VQGANPlusResidualBlock_0.Conv_0,
                 enc.VQGANPlusResidualBlock_0.Conv_2, dec.Conv_0,
                 dec.VQGANPlusResidualBlock_1.Conv_1):
        assert isinstance(site, tquant.QuantConv)
    for head in (enc.Conv_2, enc.Conv_3, dec.Conv_1):          # the plain heads
        assert not isinstance(head, tquant.QuantConv)
    assert set(to_jax_flat(q, VQVAE_PREFIXES)) == set(to_jax_flat(plain, VQVAE_PREFIXES))
    bf = tcodecs.setup_codec(Config({"image_size": 32, "codec": {
        "choice": "vqgan_plus", "hidden_channels": 32, "bf16": True}}))
    assert bf.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in bf.parameters())
