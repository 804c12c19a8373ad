"""One flow-matching step of the port on an HDiT velocity field, dense and
with MoE feed-forward blocks at the outer level, against the JAX
package's ``make_flow_train_step`` on the same weights (HDiT widths 16 and
32, d_head 8, neighborhood attention k 3 outer, global inner; 8×8×4
latents at patch 2; 3 classes; B=8). The zero-init projections are
perturbed first, so that every gradient is nonzero. The draws and the drop
gate are injected; the MoE auxiliary loss enters as the JAX script folds it
in: 1e-2 × the mean of the blocks' sown losses.

Tolerances: the loss, ``loss_flow`` and ``loss_model_aux`` 1e-5; the
parameters and the EMA after the step 1e-4 absolute, Adam's first moments
1e-4 · the largest |ref| plus 1e-3 relative (``test_torch_flow_step.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models import hdit as jh
from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training import schedules as jsched
from flocoder_tpu.training.checkpoint import flatten_tree, unflatten_tree
from flocoder_torch.models import hdit as th
from flocoder_torch.models.layers import init_params
from flocoder_torch.training import flow as tflow
from flocoder_torch.training import schedules as tsched
from flocoder_torch.training.checkpoint import UNET_PREFIXES, to_jax_flat
from test_torch_flow_step import ATOL, NC, _assert_close_tree, _batch, _jax_draws
from test_torch_flow_train_step import _jax_mu, _torch_mu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


AUX_W = 1e-2     # flow.hdit_moe_aux_weight's default


def _models(moe: int, seed: int):
    def levels(m):
        return (m.LevelSpec(1, 16, 32, m.NeighborhoodAttentionSpec(d_head=8, kernel_size=3),
                            moe_experts=moe, moe_capacity=0.75),
                m.LevelSpec(1, 32, 64, m.GlobalAttentionSpec(d_head=8)))
    kw = dict(channels=4, patch_size=2, n_classes=NC)
    tm = th.HDiT(levels(th), th.MappingSpec(1, 32, 64), **kw)
    jm = jh.HDiT(levels(jh), jh.MappingSpec(1, 32, 64), **kw)
    init_params(tm, torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(torch.from_numpy(0.05 * rng.normal(size=tuple(p.shape)).astype(np.float32)))
    jparams = unflatten_tree({k: jnp.asarray(v) for k, v in
                              to_jax_flat(tm, UNET_PREFIXES).items()})
    if not moe:
        return tm, jparams, (lambda p, x, t, c: jm.apply(p, x, t, c)), None

    def japply(p, x, t, c):        # the JAX script's train_model_apply
        v, mut = jm.apply(p, x, t, c, mutable=["moe_losses"])
        leaves = jax.tree_util.tree_leaves(mut)
        return v, AUX_W * (sum(leaves) / len(leaves))

    def tapply(m, x, t, c):        # the port's train_flow model_apply
        v, aux = m(x, t, c, return_aux=True)
        return v, AUX_W * aux["moe_aux"].mean()

    return tm, jparams, japply, tapply


@pytest.mark.parametrize("moe", [0, 4])
def test_hdit_train_step_matches_jax(moe):
    tm, jparams, japply, tapply = _models(moe, seed=30 + moe)
    jb, tb = _batch(31)
    sched_kw = dict(T_0=2, steps_per_epoch=3)
    tx = jflow.make_flow_optimizer(jsched.cosine_warm_restarts_decay(1e-4, **sched_kw))
    jstate = jflow.create_flow_state(jparams, tx)
    jstep = jflow.make_flow_train_step(japply, tx, ema_decay=0.9, cfg_dropout=0.5,
                                       donate=False)
    rng = jax.random.PRNGKey(32)
    jstate, jaux = jax.block_until_ready(jstep(jstate, jb, rng))

    k_gate, k_body = jax.random.split(rng)
    drop = torch.tensor(bool(jax.random.uniform(k_gate) < 0.5))
    state = tflow.create_flow_state(tm, tsched.cosine_warm_restarts_decay(1e-4, **sched_kw))
    step = tflow.make_flow_train_step(ema_decay=0.9, model_apply=tapply)
    state, aux = step(state, tb, None, draws=[_jax_draws(k_body)], drop=drop)
    keys = ("loss", "loss_flow") + (("loss_model_aux",) if moe else ())
    assert ("loss_model_aux" in aux) == bool(moe) == ("loss_model_aux" in jaux)
    for k in keys:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(aux["grad_norm"]), float(jaux["grad_norm"]),
                               rtol=1e-4, atol=ATOL)
    _assert_close_tree(to_jax_flat(state.model, UNET_PREFIXES), flatten_tree(jstate.params),
                       "parameters", scaled=False)
    _assert_close_tree(to_jax_flat(state.ema, UNET_PREFIXES), flatten_tree(jstate.ema),
                       "EMA", scaled=False)
    _assert_close_tree(_torch_mu(state), _jax_mu(jstate.opt_state), "Adam mu", scaled=True)
    # the gradient reached the attention through the perturbed zero-init weights
    mu = _torch_mu(state)
    assert np.abs(mu["model/params/down_0_attn_0/qkv/kernel"]).max() > 0


def test_moe_aux_loss_through_the_curvature_jvp():
    """The curvature term's forward-mode pass (``torch.func.jvp``) carries
    the (v, model_aux) pair, as the JAX step's ``jax.jvp`` does."""
    tm, jparams, japply, tapply = _models(4, seed=40)
    jb, tb = _batch(41)
    rng = jax.random.PRNGKey(42)
    (_, jaux), _ = jax.jit(jflow.make_flow_grads_fn(japply, curvature_weight=1e-3))(
        jparams, jnp.zeros((), jnp.int32), jb, rng, jnp.asarray(False))
    aux = tflow.make_flow_grads_fn(curvature_weight=1e-3, model_apply=tapply)(
        tm, tb, torch.tensor(False), draws=_jax_draws(rng))
    for k in ("loss", "loss_flow", "loss_model_aux", "loss_curvature"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
