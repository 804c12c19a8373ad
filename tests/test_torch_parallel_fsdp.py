"""The FSDP flow step: the port's on 2 gloo ranks (the U-Net and its EMA
FSDP2 modules split by the JAX rule with ``min_size`` lowered to 64, as
``tests/test_distributed.py`` lowers it, so that several tensors shard;
each rank with its 8 rows of a global batch of 16) against the JAX
package's FSDP step (``shard_state`` on a 2-device mesh and the plain-jit
step, the one-device function on the global batch) over 3 steps on the
same weights, every step's global draws and gate those the JAX step makes
from its key. Tolerances: the losses 1e-4 (``test_torch_flow_step.py``'s);
parameters and EMA after the 3 steps 1e-4 absolute plus 1e-3 relative,
the JAX package's own for its FSDP step against its replicated one (its
sharded program sums in another order), and Adam's first moments 1e-4 ·
the largest |μ| plus 1e-3 relative. At least one parameter stays sharded
through the steps.

The named mutation: the data-parallel step on the same rows and draws
(OT pairing within each rank's rows instead of over the global batch)
misses the FSDP step's first moments.
"""
import jax
import numpy as np
import optax
import pytest

from flocoder_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flocoder_tpu.parallel.mesh import shard_batch as jax_shard_batch
from flocoder_tpu.parallel.mesh import shard_state as jax_shard_state
from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training.checkpoint import flatten_tree
from test_torch_flow_step import ATOL, B, _assert_close_tree, _batch, _jax_draws, _models
from test_torch_parallel_flow import LR, unet_models
from test_torch_parallel_ranks import flow_fsdp_rank, start_ranks

N_STEPS, MIN_SIZE = 3, 64


def jax_fsdp_run(jparams, japply, jb, keys):
    """The JAX FSDP run: state placed by ``shard_state``, the plain-jit step."""
    mesh = jax_make_mesh(n_data=2, devices=jax.devices()[:2])
    tx = jflow.make_flow_optimizer(LR)
    step = jflow.make_flow_train_step(japply, tx, donate=False)
    state = jax_shard_state(mesh, jflow.create_flow_state(jparams, tx), min_size=MIN_SIZE)
    batch = jax_shard_batch(mesh, jb)
    auxs = []
    for k in keys:
        state, aux = step(state, batch, k)
        auxs.append({k_: float(v) for k_, v in aux.items()})
    return jax.block_until_ready(state), auxs


def jax_step_draws(keys, n):
    """Each step's global draws and gate (the JAX step's key split)."""
    out = []
    for k in keys:
        k_gate, k_body = jax.random.split(k)
        out.append((_jax_draws(k_body, n=n), bool(jax.random.uniform(k_gate) < 0.1)))
    return out


def _mu(flat) -> dict:
    return {k[len("1/0/mu/"):]: v for k, v in flat.items() if k.startswith("1/0/mu/")}


def _jax_mu(opt_state) -> dict:
    isa = lambda s: isinstance(s, optax.ScaleByAdamState)
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=isa) if isa(s)]
    return flatten_tree(adam.mu)


def _close(ours: dict, ref: dict, what: str):
    assert set(ours) == set(ref), what
    for k in ref:
        np.testing.assert_allclose(np.asarray(ours[k], np.float64),
                                   np.asarray(ref[k], np.float64), rtol=1e-3, atol=ATOL,
                                   err_msg=f"{what}: {k}")


def test_two_rank_fsdp_step_matches_jax_fsdp(tmp_path):
    unet, jparams, japply = _models(seed=31)
    jb, tb = _batch(32, n=2 * B)
    keys = [jax.random.PRNGKey(40 + i) for i in range(N_STEPS)]
    steps = jax_step_draws(keys, 2 * B)
    ranks = start_ranks(flow_fsdp_rank, 2, tmp_path, unet_models(unet), tb["target"].numpy(),
                        tb["class_cond"].numpy().astype(np.int64), steps, LR, MIN_SIZE, None,
                        [True, False])
    jstate, jauxs = jax_fsdp_run(jparams, japply, jb, keys)
    res = ranks.join()
    ref_mu = _jax_mu(jstate.opt_state)
    for fsdp_run, _ in res:
        assert 0 < fsdp_run["n_sharded"] < len(fsdp_run["dims"])
        assert fsdp_run["n_sharded"] == sum(d is not None for d in fsdp_run["dims"].values())
        for ours, ref in zip(fsdp_run["aux"], jauxs):
            for k in ("loss", "loss_flow", "grad_norm"):
                np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, atol=ATOL, err_msg=k)
        _close(fsdp_run["params"], flatten_tree(jstate.params), "parameters")
        _close(fsdp_run["ema"], flatten_tree(jstate.ema), "EMA")
        _assert_close_tree(_mu(fsdp_run["opt"]), ref_mu, "Adam mu", scaled=True)

    # mutation: per-rank OT (the data-parallel step) on the same rows and draws
    with pytest.raises(AssertionError):
        for _, dp_run in res:
            _assert_close_tree(_mu(dp_run["opt"]), ref_mu, "Adam mu", scaled=True)
