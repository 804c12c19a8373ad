"""Reflow pairs in the port (``flocoder_torch/make_reflow_pairs.py``) against
the JAX package on the CPU. The tools' trees and loaders are held in
``test_torch_reflow_tools.py``, training on the pairs and serving the
reflowed checkpoint in ``test_torch_reflow_train.py``.

- ``sample_pairs`` against JAX ``generate_latents(..., source=noise)`` on the
  same injected noise and labels and the same weights, for a tiny U-Net and
  a tiny HDiT with the NA variant (patch 2, ``na:3`` outer, global inner, on
  8×8×4 latents; the JAX NA2D on its plain path, as its own CPU tests run
  it), Euler and RK4, CFG 3.0 with labels, fp32: within 1e-4·max(1, |ref|).
- Both ``PreEncodedDataset``s number class directories by their sorted
  position: a split that misses a label renumbers the labels after it, in
  both alike.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu import sampling as jsampling
from flocoder_tpu.config import load_config as jload_config
from flocoder_tpu.data import datasets as jdata
from flocoder_tpu.models import hdit as jh
from flocoder_tpu.models.unet import Unet as JaxUnet
from flocoder_tpu.training.checkpoint import _path_part, flatten_tree, unflatten_tree
from flocoder_torch import make_reflow_pairs as mrp
from flocoder_torch.config import Config, load_config
from flocoder_torch.data import datasets as tdata
from flocoder_torch.generate_samples import CONFIG_DIR
from flocoder_torch.models.flow_model import build_flow_model
from flocoder_torch.training.checkpoint import UNET_PREFIXES, load_jax_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HDIT_TINY = ["flow.hdit_depths=[1,1]", "flow.hdit_widths=[16,32]", "flow.hdit_d_ffs=[32,64]",
             "flow.hdit_d_head=8", "flow.hdit_mapping_depth=1", "flow.hdit_mapping_width=32",
             "flow.hdit_mapping_d_ff=64", "flow.hdit_patch_size=2",
             "flow.hdit_attns=[na:3,global]", "flow.unet.n_classes=3"]
# the U-Net teacher of the JAX tool's own test (tests/test_e2e_scripts.py):
# 8×8×3 resize latents, dim_mults (1, 2), 4 classes
UNET_CFG = {"image_size": 8, "no_wandb": True, "n_classes": 4, "dim_mults": [1, 2],
            "codec": {"choice": "resize", "image_size": 8, "latent_shape": [3, 8, 8]}}


def random_params(model, shape, seed):
    """Seeded random parameters in the tree of ``model.init`` (its shapes
    from ``jax.eval_shape``, no compile): N(0, 1/fan_in) kernels, N(0, 0.1²)
    elsewhere, so that every zero-init projection carries signal."""
    tmpl = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, *shape)),
                          jnp.zeros((1,)), {"class_cond": jnp.zeros((1,), jnp.int32),
                                            "mask_cond": None})["params"]
    rng = np.random.default_rng(seed)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tmpl)[0]:
        key = "/".join(_path_part(p) for p in path)
        std = (1.0 / np.sqrt(np.prod(leaf.shape[:-1])) if key.endswith("kernel")
               and len(leaf.shape) > 1 else 0.1)
        flat[key] = jnp.asarray(std * rng.standard_normal(leaf.shape), leaf.dtype)
    return unflatten_tree(flat)


def _teacher(arch: str):
    """(JAX model, its params, the port's model on the same weights,
    n_classes, latent shape)."""
    if arch == "hdit":
        overrides = [*HDIT_TINY, "codec.image_size=64"]
        jcfg = jload_config("flowers_hdit", config_dir=CONFIG_DIR, overrides=overrides)
        tcfg = load_config("flowers_hdit", config_dir=CONFIG_DIR, overrides=overrides)
        jm = jh.hdit_from_config(jcfg, channels=4, n_classes=3, dtype=jnp.float32)
        n_classes, shape = 3, (8, 8, 4)
    else:
        jm = JaxUnet(dim=8, channels=3, dim_mults=(1, 2), n_classes=4)
        tcfg, n_classes, shape = Config(UNET_CFG), 4, (8, 8, 3)
    params = random_params(jm, shape, 1)
    model = build_flow_model(tcfg, shape[-1], n_classes, dim=shape[0])
    load_jax_flat(model, {f"model/params/{k}": np.asarray(v)
                          for k, v in flatten_tree(params).items()}, UNET_PREFIXES)
    return jm, params, model.eval(), n_classes, shape


@pytest.mark.parametrize("arch", ["unet", "hdit"])
def test_sample_pairs_match_jax_generate_latents(arch):
    jm, params, model, n_classes, shape = _teacher(arch)
    rng = np.random.default_rng(2)
    noise = rng.standard_normal((4, *shape)).astype(np.float32)
    labels = rng.integers(0, n_classes, size=4, dtype=np.int32)
    for method, n_steps in (("euler", 3), ("rk4", 3)):
        ref, jnfe = jax.jit(lambda p, x, c, method=method, n_steps=n_steps:
                            jsampling.generate_latents(
                                lambda xx, t, cc: jm.apply({"params": p}, xx, t, cc),
                                x.shape, jax.random.PRNGKey(0), method=method,
                                n_steps=n_steps, cond={"class_cond": c, "mask_cond": None},
                                cfg_strength=3.0, source=x))(
            params, jnp.asarray(noise), jnp.asarray(labels))
        lat, nfe = mrp.sample_pairs(model, torch.from_numpy(noise), labels, n_classes,
                                    method, n_steps, 3.0)
        ref = np.asarray(ref)
        assert nfe == int(jnfe) == (2 if method == "euler" else 8)
        assert float(np.abs(ref - noise).max()) > 0.1            # the field moved the noise
        np.testing.assert_allclose(lat.numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(ref).max())))


def test_class_directories_renumber_alike(tmp_path):
    """A split without label 1: both packages read label 2 as class 1."""
    for label in ("0000", "0002", "0003"):
        d = tmp_path / label
        d.mkdir()
        np.savez(d / "b000000_000.npz", target_latents=np.zeros((2, 2, 1), np.float32),
                 source_latents=np.ones((2, 2, 1), np.float32))
    tds, jds = tdata.PreEncodedDataset(str(tmp_path)), jdata.PreEncodedDataset(str(tmp_path))
    assert tds.class_map == jds.class_map == {"0000": 0, "0002": 1, "0003": 2}
    rng = np.random.default_rng(0)
    got = [int(tds.get(i, rng)[1]) for i in range(3)]
    assert got == [int(jds.get(i, rng)[1]) for i in range(3)] == [0, 1, 2]
