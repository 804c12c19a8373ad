"""The port's checkpoints and config against the JAX package's: npz files
cross between the two frameworks in both directions with strict key
matching, and the port's own copy of the config system composes the repo's
recipes exactly as the JAX package's does."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu import config as jconfig
from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training import checkpoint as jckpt
from flocoder_torch import config as tconfig
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models.layers import init_params
from flocoder_torch.models.unet import Unet
from flocoder_torch.training import checkpoint as tckpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; torch's default of one
    thread per core oversubscribes them, and its OpenMP pool then stalls
    (a 0.5 s test took 30 s). One thread each keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


UNET_KW = dict(dim=8, channels=4, dim_mults=(1, 2), n_classes=3)
VQ_KW = dict(hidden_channels=16, num_downsamples=2, internal_dim=8,
             vq_embedding_dim=4, vq_num_embeddings=8, codebook_levels=2)


def _jax_trees():
    """The JAX flow and codec parameter trees (structure from flax's init,
    traced abstractly; values seeded numpy)."""
    rng = np.random.default_rng(0)

    def fill(tree):
        return jax.tree_util.tree_map(
            lambda s: rng.normal(size=s.shape).astype(s.dtype), tree)

    jm = JaxUnet(**UNET_KW)
    flow = {"model": fill(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,)), {"class_cond": jnp.zeros((1,), jnp.int32)}))}
    codec = fill(jax.eval_shape(jcodecs.VQVAE(**VQ_KW).init,
                                jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3))))
    return flow, codec


def test_jax_checkpoints_load_into_the_port_strictly(tmp_path):
    flow, codec = _jax_trees()
    cfg = jconfig.load_config("smoke_vqgan", config_dir="configs")
    fpath = jckpt.save_checkpoint(flow, 3, ckpt_dir=str(tmp_path), prefix="flow_",
                                  ema=flow, config=cfg)
    cpath = jckpt.save_checkpoint(codec, 1, ckpt_dir=str(tmp_path), prefix="vqgan_")
    ck = tckpt.load_checkpoint(fpath)
    assert ck["epoch"] == 3 and ck["config"] == cfg
    unet = tckpt.load_jax_flat(Unet(**UNET_KW), ck["ema_state_dict"],
                               tckpt.UNET_PREFIXES)
    kernel = np.asarray(flow["model"]["params"]["ResnetBlock_2"]["Block_0"]
                        ["Conv_0"]["kernel"])                       # HWIO
    np.testing.assert_array_equal(
        unet.ResnetBlock_2.Block_0.Conv_0.weight.detach().numpy(),
        kernel.transpose(3, 2, 0, 1))
    vq = tckpt.load_jax_flat(tcodecs.VQVAE(**VQ_KW),
                             tckpt.load_checkpoint(cpath)["model_state_dict"],
                             tckpt.VQVAE_PREFIXES)
    dense = np.asarray(codec["decoder"]["params"]["EncDecResidualBlock_1"]
                       ["NATTENBlock_0"]["Dense_0"]["kernel"])      # (in, out)
    np.testing.assert_array_equal(
        vq.decoder.EncDecResidualBlock_1.NATTENBlock_0.Dense_0.weight.detach().numpy(),
        dense.T)
    assert vq.vq.initted.dtype == torch.bool


def test_port_checkpoints_load_into_jax_strictly(tmp_path):
    flow, codec = _jax_trees()
    unet = init_params(Unet(**UNET_KW), torch.Generator().manual_seed(0))
    vq = init_params(tcodecs.VQVAE(**VQ_KW), torch.Generator().manual_seed(1))
    fpath = tckpt.save_checkpoint(tckpt.to_jax_flat(unet, tckpt.UNET_PREFIXES),
                                  7, ckpt_dir=str(tmp_path))
    cpath = tckpt.save_checkpoint(tckpt.to_jax_flat(vq, tckpt.VQVAE_PREFIXES),
                                  7, ckpt_dir=str(tmp_path), prefix="vqgan_")
    jflow = jckpt.load_into_tree(flow, jckpt.flatten_tree(
        jckpt.load_checkpoint(fpath)["model_state_dict"]), strict=True)
    jcodec = jckpt.load_into_tree(codec, jckpt.flatten_tree(
        jckpt.load_checkpoint(cpath)["model_state_dict"]), strict=True)
    np.testing.assert_array_equal(
        np.asarray(jflow["model"]["params"]["Embed_0"]["embedding"]),
        unet.Embed_0.weight.detach().numpy())
    np.testing.assert_array_equal(
        np.asarray(jcodec["encoder"]["params"]["GroupNorm_0"]["scale"]),
        vq.encoder.GroupNorm_0.weight.detach().numpy())


def test_bridge_is_strict():
    flat = tckpt.to_jax_flat(Unet(**UNET_KW), tckpt.UNET_PREFIXES)
    missing = dict(flat)
    missing.pop("model/params/init_conv/bias")
    with pytest.raises(KeyError, match="missing"):
        tckpt.load_jax_flat(Unet(**UNET_KW), missing, tckpt.UNET_PREFIXES)
    with pytest.raises(KeyError, match="extra"):
        tckpt.load_jax_flat(Unet(**UNET_KW), {**flat, "model/params/x": np.zeros(1)},
                            tckpt.UNET_PREFIXES)
    wrong = {**flat, "model/params/init_conv/bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_jax_flat(Unet(**UNET_KW), wrong, tckpt.UNET_PREFIXES)


@pytest.mark.parametrize("name,overrides", [
    ("flowers_vqgan", ["flow.unet.n_classes=102", "+n_samples=8", "~codec.lambda_ce"]),
    ("smoke_vqgan.yaml", ["codec.hidden_channels=8", "flow.batch_size=4"]),
    ("midi_vqgan", []),
])
def test_config_copy_composes_like_jax(name, overrides):
    ours = tconfig.load_config(name, config_dir="configs", overrides=overrides)
    ref = jconfig.load_config(name, config_dir="configs", overrides=overrides)
    assert tconfig.to_dict(ours) == jconfig.to_dict(ref)
    for key in ("n_classes", "hidden_channels", "batch_size", "image_size",
                "commitment_weight", "missing_key"):
        assert tconfig.ldcfg(ours, key, 7) == jconfig.ldcfg(ref, key, 7)
    argv = ["--config-name", name, *overrides]
    assert tconfig.parse_cli(argv, config_dir="configs") == \
        jconfig.parse_cli(argv, config_dir="configs")
