"""The RVQ's cross-rank statistics: a 2-rank training call of the port's
``rvq_apply`` (``mesh``: counts and sums summed over the ranks, k-means
centres and reseed candidates batch rank 0's) against the JAX package's
``rvq_apply`` under ``shard_map`` on 2 devices (``psum`` and ``_bcast0``).
Every rank draws the same k-means seed rows and reseed picks from the
same key, as every JAX shard does; the port is handed them
(``_jax_draws``). The picks must agree exactly, z_q, the commitment
losses and the new state to 1e-5 (``test_torch_rvq.py``'s tolerance); the
state must be bitwise the same on both ranks.

The named mutation: the ranks without the mesh (each folds only its own
rows' statistics and keeps its own k-means) miss the JAX state.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from flocoder_tpu.ops import rvq as jrvq
from flocoder_tpu.parallel.mesh import shard_map
from test_torch_parallel_ranks import rvq_rank, run_ranks

ATOL = 1e-5
L, K, D, N = 3, 16, 4, 256


def _jax_draws(key, n):
    seeds = [np.asarray(jax.random.randint(k, (K,), 0, n)) for k in jax.random.split(key, L)]
    picks = [np.asarray(jax.random.randint(jax.random.fold_in(key, lvl + 1), (K,), 0, n))
             for lvl in range(L)]
    return np.stack(seeds), np.stack(picks)


def _state(seed, initted, dead):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(L, K, D)).astype(np.float32)
    counts = rng.uniform(3.0, 20.0, size=(L, K)).astype(np.float32)
    counts[:, :dead] = 0.5
    return {"codebooks": cb, "ema_counts": counts,
            "ema_sums": (cb * counts[..., None]).astype(np.float32),
            "initted": np.asarray(initted)}


@functools.lru_cache(maxsize=None)
def _jax_sharded():
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    def f(state, z, key):
        z_q, idx, loss, new = jrvq.rvq_apply(state, z, train=True, rng=key, axis_name="data")
        return z_q, idx, loss[None], new

    return jax.jit(shard_map(f, mesh=mesh, in_specs=(P(), P("data"), P()),
                             out_specs=(P("data"), P("data"), P("data"), P()),
                             check_rep=False))


CASES = {"kmeans": (False, 0), "reseed": (True, 4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both cases on the mesh and, the mutation, without it, in one world."""
    z = (np.random.default_rng(1).normal(size=(N, D)) * 1.5).astype(np.float32)
    key = jax.random.PRNGKey(2)
    seeds, picks = _jax_draws(key, N // 2)
    states = {name: _state(0, initted, dead) for name, (initted, dead) in CASES.items()}
    cases = [(states[name], z, seeds, picks, use_mesh)
             for name in CASES for use_mesh in (True, False)]
    res = run_ranks(rvq_rank, 2, tmp_path_factory.mktemp("rvq"), cases)
    out = {name: ([r[2 * i] for r in res], [r[2 * i + 1] for r in res])
           for i, name in enumerate(CASES)}
    return dict(z=z, key=key, states=states, res=out)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_rvq_matches_jax_shard_map(runs, case):
    st, z = runs["states"][case], runs["z"]
    jz, jidx, jloss, jnew = jax.block_until_ready(_jax_sharded()(
        jrvq.RVQState(**{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(z),
        runs["key"]))
    res, cut = runs["res"][case]
    np.testing.assert_array_equal(np.concatenate([r["idx"] for r in res]), np.asarray(jidx))
    np.testing.assert_allclose(np.concatenate([r["z_q"] for r in res]), np.asarray(jz),
                               atol=ATOL)
    np.testing.assert_allclose([r["loss"] for r in res], np.asarray(jloss), atol=ATOL)
    for name in ("codebooks", "ema_counts", "ema_sums"):
        np.testing.assert_array_equal(res[0]["state"][name], res[1]["state"][name])
        np.testing.assert_allclose(res[0]["state"][name], np.asarray(getattr(jnew, name)),
                                   atol=ATOL, err_msg=name)
    assert bool(res[0]["state"]["initted"]) and bool(jnew.initted)

    # mutation: no mesh, so no psum and no broadcast from rank 0
    with pytest.raises(AssertionError):
        for r in cut:
            for name in ("codebooks", "ema_counts", "ema_sums"):
                np.testing.assert_allclose(r["state"][name], np.asarray(getattr(jnew, name)),
                                           atol=ATOL, err_msg=name)
