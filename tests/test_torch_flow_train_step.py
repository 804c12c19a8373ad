"""One optimizer step of the port's flow training (gradients, clipped Adam
on the cosine schedule, EMA) and ``grad_accum``, against
the JAX package's ``make_flow_train_step`` on the same U-Net weights with
the draws and the drop gate injected. Helpers and tolerances are those of
``test_torch_flow_step.py``.
"""
import copy

import jax
import numpy as np
import optax
import pytest
import torch

from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training import schedules as jsched
from flocoder_tpu.training.checkpoint import flatten_tree
from flocoder_torch.training import flow as tflow
from flocoder_torch.training import schedules as tsched
from flocoder_torch.training.checkpoint import UNET_PREFIXES, to_jax_flat
from test_torch_flow_step import (ATOL, B, _assert_close_tree, _batch, _grads,
                                  _jax_draws, _models)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_mu(opt_state) -> dict:
    isa = lambda s: isinstance(s, optax.ScaleByAdamState)
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=isa) if isa(s)]
    return flatten_tree(adam.mu)


def _torch_mu(state) -> dict:
    m = copy.deepcopy(state.model)
    with torch.no_grad():
        for pm, p in zip(m.parameters(), state.model.parameters()):
            pm.copy_(state.opt.adam.state[p]["exp_avg"])
    return to_jax_flat(m, UNET_PREFIXES)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(grad_accum):
    """One step at the recipe's lr 1e-4 on the cosine schedule with EMA 0.9
    (so the EMA moves visibly): parameters, Adam's first moments and the
    EMA. Adam's first update moves each weight by about ±lr whatever its
    gradient's size, so the gradients are held through the first moments."""
    unet, jparams, japply = _models(seed=11)
    jb, tb = _batch(12, n=2 * B if grad_accum > 1 else B)
    sched_kw = dict(T_0=2, steps_per_epoch=3)
    tx = jflow.make_flow_optimizer(jsched.cosine_warm_restarts_decay(1e-4, **sched_kw))
    jstate = jflow.create_flow_state(jparams, tx)
    jstep = jflow.make_flow_train_step(japply, tx, ema_decay=0.9, cfg_dropout=0.5,
                                       grad_accum=grad_accum, donate=False)
    rng = jax.random.PRNGKey(13)
    jstate, jaux = jax.block_until_ready(jstep(jstate, jb, rng))

    k_gate, k_body = jax.random.split(rng)
    drop = torch.tensor(bool(jax.random.uniform(k_gate) < 0.5))
    keys = jax.random.split(k_body, grad_accum) if grad_accum > 1 else [k_body]
    n = tb["target"].shape[0] // grad_accum
    state = tflow.create_flow_state(unet, tsched.cosine_warm_restarts_decay(1e-4, **sched_kw))
    step = tflow.make_flow_train_step(ema_decay=0.9, grad_accum=grad_accum)
    state, aux = step(state, tb, None, draws=[_jax_draws(k, n=n) for k in keys], drop=drop)
    assert state.step == 1
    for k in ("loss", "loss_flow", "grad_norm"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, atol=ATOL,
                                   err_msg=k)
    _assert_close_tree(to_jax_flat(state.model, UNET_PREFIXES), flatten_tree(jstate.params),
                       "parameters", scaled=False)
    _assert_close_tree(to_jax_flat(state.ema, UNET_PREFIXES), flatten_tree(jstate.ema),
                       "EMA", scaled=False)
    _assert_close_tree(_torch_mu(state), _jax_mu(jstate.opt_state), "Adam mu", scaled=True)


def test_grad_accum_is_the_mean_of_the_microbatch_gradients():
    unet, _, _ = _models(seed=14)
    _, tb = _batch(15, n=2 * B)
    draws = [_jax_draws(jax.random.PRNGKey(16 + i)) for i in range(2)]
    grads_fn = tflow.make_flow_grads_fn()
    per = []
    for i in range(2):
        m = copy.deepcopy(unet)
        grads_fn(m, {k: v[i * B:(i + 1) * B] for k, v in tb.items()}, torch.tensor(False),
                 draws=draws[i])
        per.append(_grads(m))
    state = tflow.create_flow_state(copy.deepcopy(unet), 1e-3)
    state.opt.step = lambda count=0: torch.zeros(())       # keep the gradients
    tflow.make_flow_train_step(grad_accum=2)(state, tb, None, draws=draws,
                                             drop=torch.tensor(False))
    acc = _grads(state.model)
    for k in acc:
        np.testing.assert_allclose(acc[k], (per[0][k] + per[1][k]) / 2, rtol=1e-5,
                                   atol=1e-6 * np.abs(acc[k]).max(), err_msg=k)
