"""The data-parallel flow step: the port's on 2 gloo ranks (each on its 8
rows of a global batch of 16, with its own noise, t and CFG noise, the
gate shared) against the documented function computed with the JAX
package: its ``make_flow_grads_fn`` on each shard's rows with that shard's
draws (OT pairing within the shard), the gradients and losses averaged in
numpy, then optax's clipped Adam and the EMA. (The JAX shard_map step
itself reduces nothing under this JAX version: ROADMAP.md.) Models and
tolerances are ``test_torch_flow_step.py``'s: the loss 1e-4, parameters
and EMA after the step 1e-4 absolute, Adam's first moments 1e-4 · the
largest |μ| plus 1e-3 relative. Adam's first update moves each weight by
±lr by its gradient's sign, and the two packages sum a gradient in another
order (here a mean of two), so a weight whose reference gradient is below
fp32's noise floor (|μ| < 1e-5 · the largest |μ|) may move the other way:
there, and only there, a parameter may be off by up to 2·lr.

The named mutation, the check that fails if the port's step skips the
cross-rank mean: the ranks without the mesh each update on their own
gradients and miss the reference's first moments.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from flocoder_tpu.training import ema as jema
from flocoder_tpu.training import flow as jflow
from flocoder_tpu.training.checkpoint import flatten_tree
from test_torch_flow_step import ATOL, B, C, NC, _assert_close_tree, _batch, _jax_draws, _models
from test_torch_parallel_ranks import flow_dp_rank, start_ranks

LR = 1e-4            # the recipe's, as test_torch_flow_train_step.py


def _jax_mu(opt_state) -> dict:
    isa = lambda s: isinstance(s, optax.ScaleByAdamState)
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=isa) if isa(s)]
    return flatten_tree(adam.mu)


def assert_params(ours: dict, ref: dict, ref_mu: dict, lr: float, what: str):
    """Within ATOL, but where the reference gradient is at the noise floor
    (module docstring)."""
    scale = max(np.abs(np.asarray(v)).max() for v in ref_mu.values())
    assert set(ours) == set(ref), what
    for k in ref:
        a, b = np.asarray(ours[k], np.float64), np.asarray(ref[k], np.float64)
        off = np.abs(a - b) > ATOL
        if off.any():
            mu = np.abs(np.asarray(ref_mu[k]))
            assert (mu[off] < 1e-5 * scale).all(), (what, k, int(off.sum()))
            np.testing.assert_allclose(a, b, atol=2 * lr + ATOL, err_msg=f"{what}: {k}")


def unet_models(unet) -> dict:
    return {"unet_kw": dict(dim=8, channels=C, dim_mults=(1, 2), n_classes=NC),
            "unet_sd": unet.state_dict()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank steps, in one world: both gates on the mesh, then the
    mutation (no mesh) with the gate off; beside them, the documented
    function for each gate with the JAX package."""
    unet, jparams, japply = _models(seed=11)
    jb, tb = _batch(12, n=2 * B)
    keys = [jax.random.PRNGKey(20 + r) for r in range(2)]
    draws = [_jax_draws(k, n=B) for k in keys]
    cases = [(False, True), (True, True), (False, False)]
    ranks = start_ranks(flow_dp_rank, 2, tmp_path_factory.mktemp("dp"), unet_models(unet),
                        tb["target"].numpy(), tb["class_cond"].numpy().astype(np.int64), draws,
                        cases, LR)
    tx = jflow.make_flow_optimizer(LR)

    @jax.jit
    def update(grads, jparams):
        """optax's clipped Adam from a fresh state, then the EMA at 0.9."""
        updates, opt = tx.update(grads, tx.init(jparams), jparams)
        params = optax.apply_updates(jparams, updates)
        return params, opt, jema.ema_update(jparams, params, 0.9)

    grads_fn = jax.jit(jflow.make_flow_grads_fn(japply))
    refs = {}
    for drop in (False, True):
        per = [grads_fn(jparams, jnp.zeros((), jnp.int32),
                        {k: v[r * B:(r + 1) * B] for k, v in jb.items()}, keys[r],
                        jnp.asarray(drop)) for r in range(2)]
        grads = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, per[0][1], per[1][1])
        params, opt, ema = update(grads, jparams)
        refs[drop] = dict(loss=(float(per[0][0][0]) + float(per[1][0][0])) / 2,
                          grad_norm=float(optax.global_norm(grads)),
                          params=flatten_tree(params), ema=flatten_tree(ema),
                          mu=_jax_mu(opt))
    res = ranks.join()
    return dict(refs=refs, res={case: [r[i] for r in res] for i, case in enumerate(cases)})


def _mu(r) -> dict:
    return {k[len("1/0/mu/"):]: v for k, v in r["opt"].items() if k.startswith("1/0/mu/")}


@pytest.mark.parametrize("drop", [False, True])
def test_two_rank_dp_step_is_the_documented_function(runs, drop):
    ref = runs["refs"][drop]
    ref_mu = ref["mu"]
    for r in runs["res"][(drop, True)]:
        np.testing.assert_allclose(r["aux"]["loss"], ref["loss"], atol=ATOL)
        np.testing.assert_allclose(r["aux"]["grad_norm"], ref["grad_norm"], rtol=1e-4)
        assert_params(r["params"], ref["params"], ref_mu, LR, "parameters")
        assert_params(r["ema"], ref["ema"], ref_mu, 0.1 * LR, "EMA")
        _assert_close_tree(_mu(r), ref_mu, "Adam mu", scaled=True)

    if not drop:        # mutation: the step without its cross-rank mean
        with pytest.raises(AssertionError):
            for r in runs["res"][(False, False)]:
                _assert_close_tree(_mu(r), ref_mu, "Adam mu", scaled=True)
