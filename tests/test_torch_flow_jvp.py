"""The port's forward-mode terms of the flow step (the curvature penalty
here, MeanFlow's target in ``test_torch_flow_meanflow.py``;
``torch.func.jvp``) against the JAX package's ``jax.jvp`` on the same
U-Net weights, with the draws injected. Helpers and
tolerances are those of ``test_torch_flow_step.py``: values 1e-4 absolute
(1e-4 relative for the losses), gradients 1e-4 · the model's largest |ref|
plus 1e-3 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training.checkpoint import flatten_tree
from flocoder_torch.training import flow as tflow
from test_torch_flow_step import (ATOL, _assert_close_tree, _batch, _grads,
                                  _jax_draws, _models)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_curvature_term_matches_jax_jvp():
    unet, jparams, japply = _models(seed=4)
    jb, tb = _batch(5)
    rng = jax.random.PRNGKey(6)
    (jloss, jaux), jg = jflow.make_flow_grads_fn(japply, curvature_weight=1e-6)(
        jparams, jnp.zeros((), jnp.int32), jb, rng, jnp.asarray(False))
    aux = tflow.make_flow_grads_fn(curvature_weight=1e-6)(
        unet, tb, torch.tensor(False), draws=_jax_draws(rng))
    for k in ("loss", "loss_flow", "loss_curvature"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-4, atol=ATOL,
                                   err_msg=k)
    _assert_close_tree(_grads(unet), flatten_tree(jg), "gradient", scaled=True)
