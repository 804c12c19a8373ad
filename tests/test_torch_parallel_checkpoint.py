"""Sharded checkpoints between the two packages, exactly: the port's
2-rank FSDP run writes ``flow_1.host{0,1}.npz`` (each rank its blocks in
the flax layout, rank 0 the replicated leaves as ``@r``) and the JAX
package's ``load_checkpoint_sharded`` reassembles the port's whole state
from them; the JAX package's FSDP-placed state written by its
``save_checkpoint_sharded`` on a 2-device mesh is reassembled by the
port's loader, and loads into the port's U-Net.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from flocoder_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flocoder_tpu.parallel.mesh import shard_state as jax_shard_state
from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training.checkpoint import flatten_tree
from flocoder_tpu.training.checkpoint import load_checkpoint_sharded as jax_load_sharded
from flocoder_tpu.training.checkpoint import save_checkpoint_sharded as jax_save_sharded
from flocoder_torch.models.unet import Unet
from flocoder_torch.training.checkpoint import (UNET_PREFIXES, load_checkpoint_sharded,
                                                load_jax_flat, subtree, to_jax_flat)
from test_torch_flow_step import B, C, NC, S, _batch, _models
from test_torch_parallel_flow import LR, unet_models
from test_torch_parallel_ranks import flow_fsdp_rank, run_ranks


def test_port_sharded_checkpoint_reads_in_jax(tmp_path):
    unet, _, _ = _models(seed=51)
    _, tb = _batch(52, n=2 * B)
    g = torch.Generator().manual_seed(53)
    shape = (2 * B, S, S, C)
    draws = {"noise": torch.randn(shape, generator=g), "t_uniform": torch.rand(2 * B, generator=g),
             "cfg_noise": torch.randn(shape, generator=g)}
    ck = str(tmp_path / "ck")
    res = run_ranks(flow_fsdp_rank, 2, tmp_path, unet_models(unet), tb["target"].numpy(),
                    tb["class_cond"].numpy().astype(np.int64), [(draws, False)], LR, 64, ck,
                    [True])
    (r0,), (r1,) = res
    assert sorted(os.listdir(ck)) == ["flow_1.host0.npz", "flow_1.host1.npz"]
    with np.load(os.path.join(ck, "flow_1.host1.npz")) as f:
        keys1 = list(f.files)
    with np.load(os.path.join(ck, "flow_1.host0.npz")) as f:
        keys0 = list(f.files)
    assert keys1 and not any(k.endswith("@r") for k in keys1)
    assert any(k.endswith("@r") for k in keys0) and "epoch" in keys0
    # a block of rank 1 starts past 0 on the dim that flax's layout splits
    assert any(any(int(o) for o in k.rsplit("@", 1)[1].split("-")) for k in keys1)
    want = {**{f"params/{k}": v for k, v in r0["params"].items()},
            **{f"ema/{k}": v for k, v in r0["ema"].items()},
            **{f"opt_state/{k}": v for k, v in r0["opt"].items()}}
    for got in (flatten_tree(jax_load_sharded(ck, "flow_", 1)["state"]),
                load_checkpoint_sharded(ck, "flow_", 1)["state"]):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v), err_msg=k)
    for k in r0["params"]:
        np.testing.assert_array_equal(r0["params"][k], r1["params"][k])
    # optax's whole Adam state loads back into a fresh sharded optimizer
    for r in (r0, r1):
        assert set(r["resumed"]) == set(r0["opt"])
        for k, v in r0["opt"].items():
            np.testing.assert_array_equal(np.asarray(r["resumed"][k]), np.asarray(v), err_msg=k)


def test_jax_sharded_checkpoint_reads_in_the_port(tmp_path):
    unet, jparams, _ = _models(seed=54)
    tx = jflow.make_flow_optimizer(LR)
    rng = np.random.default_rng(55)
    state = jflow.create_flow_state(jparams, tx)
    state = jax.tree_util.tree_map(       # every leaf its own numbers
        lambda x: jnp.asarray(rng.normal(size=np.shape(x)).astype(np.asarray(x).dtype))
        if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x, state)
    mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
    state = jax_shard_state(mesh, state, min_size=64)
    assert any(not x.sharding.is_fully_replicated for x in jax.tree_util.tree_leaves(state.params))
    tree = {"params": state.params, "opt_state": state.opt_state, "ema": state.ema}
    jax_save_sharded(tree, 2, ckpt_dir=str(tmp_path), prefix="flow_")
    got = load_checkpoint_sharded(str(tmp_path), "flow_", 2)
    want = flatten_tree(jax.device_get(tree))
    assert got["epoch"] == 2 and set(got["state"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got["state"][k], np.asarray(v), err_msg=k)
    fresh = Unet(dim=8, channels=C, dim_mults=(1, 2), n_classes=NC)
    load_jax_flat(fresh, subtree(got["state"], "params/", strip=True), UNET_PREFIXES)
    ours = to_jax_flat(fresh, UNET_PREFIXES)
    for k, v in ours.items():
        np.testing.assert_array_equal(v, got["state"][f"params/{k}"], err_msg=k)
