"""The port's RVQ (flocoder_torch.ops.rvq) against the JAX package's
``rvq_apply``: the same numpy tokens and state go to both; in training the
port is handed the JAX package's own random draws (its k-means seed rows
and dead-code reseed picks, recomputed here from the same key).

Picks must agree exactly; z_q, the commitment loss, the new state and the
rotation-trick gradients within 1e-5 (fp32, values of magnitude ~1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.ops import rvq as jrvq
from flocoder_torch.ops import rvq as trvq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; one torch thread each
    keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5
L, K, D, N = 3, 16, 4, 256


def _states(seed, initted, dead=0):
    """The same state for both packages: seeded codebooks, EMA statistics
    that keep every code alive except the first ``dead`` of each level."""
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(L, K, D)).astype(np.float32)
    counts = rng.uniform(3.0, 20.0, size=(L, K)).astype(np.float32)
    counts[:, :dead] = 0.5
    sums = (cb * counts[..., None]).astype(np.float32)
    j = jrvq.RVQState(codebooks=jnp.asarray(cb), ema_counts=jnp.asarray(counts),
                      ema_sums=jnp.asarray(sums), initted=jnp.asarray(initted))
    t = trvq.RVQState(L, K, D)
    t.assign_({"codebooks": torch.from_numpy(cb),
               "ema_counts": torch.from_numpy(counts),
               "ema_sums": torch.from_numpy(sums),
               "initted": torch.tensor(initted)})
    return j, t


def _jax_draws(key, n):
    """The JAX package's k-means seeds and reseed picks for ``key``
    (flocoder_tpu/ops/rvq.py: split into L keys; fold_in(key, level + 1))."""
    seeds = [np.asarray(jax.random.randint(k, (K,), 0, n))
             for k in jax.random.split(key, L)]
    picks = [np.asarray(jax.random.randint(jax.random.fold_in(key, lvl + 1),
                                           (K,), 0, n)) for lvl in range(L)]
    return np.stack(seeds), np.stack(picks)


def _tokens(seed):
    return np.random.default_rng(seed).normal(size=(N, D)).astype(np.float32) * 1.5


def _compare(jout, tout):
    jz, jidx, jloss, jstate = jout
    tz, tidx, tloss, tstate = tout
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tz.detach().numpy(), np.asarray(jz), atol=ATOL)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=ATOL)
    for name in ("codebooks", "ema_counts", "ema_sums"):
        np.testing.assert_allclose(tstate[name].numpy(),
                                   np.asarray(getattr(jstate, name)),
                                   atol=ATOL, err_msg=name)
    assert bool(tstate["initted"]) == bool(jstate.initted)


def test_eval_picks_are_exact():
    jstate, tstate = _states(0, True)
    z = _tokens(1)
    jout = jrvq.rvq_apply(jstate, jnp.asarray(z), train=False)
    tout = trvq.rvq_apply(tstate, torch.from_numpy(z), train=False)
    _compare(jout, tout)
    np.testing.assert_array_equal(trvq.rvq_encode(tstate, torch.from_numpy(z)).numpy(),
                                  np.asarray(jrvq.rvq_encode(jstate, jnp.asarray(z))))
    idx = np.array(jout[1])
    np.testing.assert_allclose(
        trvq.rvq_lookup(tstate, torch.from_numpy(idx)).numpy(),
        np.asarray(jrvq.rvq_lookup(jstate, jnp.asarray(idx))), atol=ATOL)


@pytest.mark.parametrize("initted,dead", [(False, 0), (True, 0), (True, 5)])
def test_train_step_matches_jax(initted, dead):
    """First batch (k-means init), an initialised state, and one with dead
    codes that take reseeded batch rows."""
    jstate, tstate = _states(2, initted, dead)
    z = _tokens(3)
    key = jax.random.PRNGKey(4)
    seeds, picks = _jax_draws(key, N)
    jout = jrvq.rvq_apply(jstate, jnp.asarray(z), train=True, rng=key,
                          commitment_weight=0.5)
    tout = trvq.rvq_apply(tstate, torch.from_numpy(z), train=True,
                          commitment_weight=0.5, kmeans_seeds=seeds,
                          reseed_picks=picks)
    _compare(jout, tout)
    assert bool(tstate.initted) == initted          # the input state is kept


def test_rotation_trick_gradients_match_jax():
    jstate, tstate = _states(5, True)
    z = _tokens(6)
    w = np.random.default_rng(7).normal(size=(N, D)).astype(np.float32)

    def jloss(zz):
        zq, _, commit, _ = jrvq.rvq_apply(jstate, zz, train=False,
                                          orthogonal_reg_weight=0.2)
        return jnp.sum(zq * jnp.asarray(w)) + commit

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(z)))
    tz = torch.from_numpy(z).requires_grad_()
    zq, _, commit, _ = trvq.rvq_apply(tstate, tz, train=False,
                                      orthogonal_reg_weight=0.2)
    (zq * torch.from_numpy(w)).sum().add(commit).backward()
    np.testing.assert_allclose(tz.grad.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(
        float(trvq.orthogonal_reg_loss(tstate.codebooks)),
        float(jrvq.orthogonal_reg_loss(jstate.codebooks)), atol=ATOL)


def test_generator_draws_run_the_training_path():
    """Without injected draws the port draws from its generator: a fresh
    state (``rvq_init``, like the JAX package's: N(0, 0.02²) codebooks,
    zero statistics) is k-means-initialised and every code that was dead
    is alive afterwards."""
    tstate = trvq.rvq_init(torch.Generator().manual_seed(1), L, K, D)
    jref = jrvq.rvq_init(jax.random.PRNGKey(0), L, K, D)
    for name in ("codebooks", "ema_counts", "ema_sums"):
        assert getattr(tstate, name).shape == getattr(jref, name).shape
    assert abs(float(tstate.codebooks.std()) - 0.02) < 0.005
    assert not bool(tstate.initted) and not float(tstate.ema_counts.abs().sum())
    z = torch.from_numpy(_tokens(9))
    g = torch.Generator().manual_seed(0)
    _, idx, loss, new = trvq.rvq_apply(tstate, z, train=True, generator=g)
    assert bool(new["initted"]) and idx.shape == (N, L)
    assert torch.isfinite(loss) and (new["ema_counts"] >= 2.0).all()
