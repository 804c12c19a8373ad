"""MeanFlow's average-velocity target and loss (``torch.func.jvp`` through
the dual-time U-Net) against the JAX package's ``jax.jvp`` on the same
weights, with the draws injected; split from ``test_torch_flow_jvp.py`` so
that the test runner's per-file workers take the two in parallel. Helpers
and tolerances are those of ``test_torch_flow_step.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training.checkpoint import flatten_tree
from flocoder_torch.training import flow as tflow
from test_torch_flow_step import (ATOL, B, C, S, _assert_close_tree, _batch, _grads,
                                  _jax_draws, _models)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_meanflow_target_and_loss_match_jax_jvp():
    unet, jparams, japply = _models(dual_time=True, seed=7)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, S, S, C)).astype(np.float32)
    v = rng.normal(size=(B, S, S, C)).astype(np.float32)
    r = rng.uniform(0, 0.5, B).astype(np.float32)
    th = (r + rng.uniform(0, 0.5, B)).astype(np.float32)
    cc = np.array([0, 1, 2, -1, 0, 1, 2, -1], np.int32)
    ju, jt = jflow.meanflow_target(
        japply, jparams["model"], jnp.asarray(x), jnp.asarray(r), jnp.asarray(th), jnp.asarray(v),
        {"class_cond": jnp.asarray(cc), "mask_cond": None}, t_scale=1.0)
    u, ut = tflow.meanflow_target(
        unet, torch.from_numpy(x), torch.from_numpy(r), torch.from_numpy(th),
        torch.from_numpy(v), {"class_cond": torch.from_numpy(cc).long(), "mask_cond": None},
        t_scale=1.0)
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(ju), atol=ATOL)
    np.testing.assert_allclose(ut.detach().numpy(), np.asarray(jt), atol=ATOL)

    jb, tb = _batch(9)
    key = jax.random.PRNGKey(10)
    kw = dict(meanflow=True, meanflow_ratio=0.5, t_scale=1.0)
    (jloss, jaux), jg = jflow.make_flow_grads_fn(japply, **kw)(
        jparams, jnp.zeros((), jnp.int32), jb, key, jnp.asarray(False))
    aux = tflow.make_flow_grads_fn(**kw)(unet, tb, torch.tensor(False),
                                         draws=_jax_draws(key, meanflow=True))
    for k in ("loss", "loss_meanflow_raw"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, atol=ATOL,
                                   err_msg=k)
    _assert_close_tree(_grads(unet), flatten_tree(jg), "gradient", scaled=True)
