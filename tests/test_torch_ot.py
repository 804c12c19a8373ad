"""The port's minibatch OT pairings and Sinkhorn divergence
(flocoder_torch.ops.ot / ops.sinkhorn) against the JAX package's on the same
numpy inputs. Inputs are continuous random draws, so no two distances tie
and every method's permutation is defined exactly.

Tolerances: permutations exactly; distances 1e-4 relative; the Sinkhorn
divergence, its chunked form and the pairing plan's loss 1e-5 absolute.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.ops import ot as jot
from flocoder_tpu.ops import sinkhorn as jsink
from flocoder_torch.ops import ot as tot
from flocoder_torch.ops import sinkhorn as tsink


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds(B, seed, shape=(4, 4, 2)):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(B, *shape)).astype(np.float32)
    t = (rng.normal(size=(B, *shape)) + 0.3).astype(np.float32)
    return s, t


def _is_perm(idx, B):
    return sorted(np.asarray(idx).tolist()) == list(range(B))


def test_pairwise_sqdist_matches_jax():
    s, t = _clouds(12, 0)
    np.testing.assert_allclose(
        tot.pairwise_sqdist(torch.from_numpy(s), torch.from_numpy(t[:7])).numpy(),
        np.asarray(jot.pairwise_sqdist(jnp.asarray(s), jnp.asarray(t[:7]))),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B", [8, 32, 64])
@pytest.mark.parametrize("method", ["greedy", "parallel", "sinkhorn"])
def test_pairings_give_the_jax_permutation(method, B):
    s, t = _clouds(B, B)
    ours = tot.compute_ot_pairing(torch.from_numpy(s), torch.from_numpy(t), method=method)
    ref = np.asarray(jot.compute_ot_pairing(jnp.asarray(s), jnp.asarray(t), method=method))
    assert ours.dtype == torch.long and _is_perm(ours, B)
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("B,block", [(32, 8), (64, 16), (16, 32)])
def test_blocked_pairing_gives_the_jax_permutation(B, block):
    s, t = _clouds(B, 100 + B)
    ours = tot.compute_ot_pairing(torch.from_numpy(s), torch.from_numpy(t), block=block)
    ref = np.asarray(jot.compute_ot_pairing(jnp.asarray(s), jnp.asarray(t), block=block))
    assert _is_perm(ours, B)
    np.testing.assert_array_equal(ours.numpy(), ref)
    if block < B:
        assert (ours.reshape(-1, block) // block == torch.arange(B // block)[:, None]).all()


@pytest.mark.parametrize("seed", range(4))
def test_outputs_are_permutations_even_with_ties(seed):
    """Duplicated points and a constant cloud tie every distance; each method
    still returns a permutation."""
    s, t = _clouds(24, seed)
    s[::2] = s[1::2]
    t[:] = t[0] if seed % 2 else t
    for method in ("greedy", "parallel", "sinkhorn"):
        idx = tot.compute_ot_pairing(torch.from_numpy(s), torch.from_numpy(t), method=method)
        assert _is_perm(idx, 24), method


@pytest.mark.parametrize("B", [8, 32, 64, 256])
def test_chunked_rounds_equal_round_by_round(B):
    s, t = _clouds(B, 7, shape=(16,))
    d = tot.pairwise_sqdist(torch.from_numpy(s), torch.from_numpy(t))[None]
    one, r1 = tot.parallel_assign(d, rounds_per_check=1)
    for k in (2, 5, 8, B):
        idx, rk = tot.parallel_assign(d, rounds_per_check=k)
        torch.testing.assert_close(idx, one, rtol=0, atol=0)
        assert int(rk) == int(r1)
    assert 1 <= int(r1) < B


def test_round_cap_falls_back_to_a_permutation():
    """Capped at one round, each column takes its nearest proposer and the
    other rows are left; the fallback gives the k-th unassigned row the
    k-th unused column, as the JAX package's safety net does."""
    s, t = _clouds(16, 3, shape=(8,))
    d = tot.pairwise_sqdist(torch.from_numpy(s), torch.from_numpy(t))
    idx, rounds = tot.parallel_assign(d[None], max_rounds=1)
    idx = idx[0].numpy()
    assert _is_perm(idx, 16) and int(rounds) == 1
    dn = d.numpy()
    best = dn.argmin(1)
    won = {int(j): min((i for i in range(16) if best[i] == j), key=lambda i: dn[i, j])
           for j in set(best.tolist())}
    assert 1 <= len(won) < 16
    for j, i in won.items():
        assert idx[i] == j
    free = sorted(set(range(16)) - set(won))
    rest = [i for i in range(16) if i not in won.values()]
    assert [int(idx[i]) for i in rest] == free


@pytest.mark.parametrize("n,m", [(16, 16), (24, 20)])
def test_sinkhorn_divergence_matches_jax(n, m):
    rng = np.random.default_rng(n + m)
    x = rng.normal(size=(n, 3, 2)).astype(np.float32)
    y = (rng.normal(size=(m, 3, 2)) * 1.2 + 0.5).astype(np.float32)
    for blur in (0.05, 0.5):
        ours = float(tsink.sinkhorn_loss(torch.from_numpy(x), torch.from_numpy(y), blur=blur))
        ref = float(jsink.sinkhorn_loss(jnp.asarray(x), jnp.asarray(y), blur=blur))
        np.testing.assert_allclose(ours, ref, atol=1e-5)
        assert ours > 0
    same = float(tsink.sinkhorn_divergence(torch.from_numpy(x), torch.from_numpy(x)))
    assert abs(same) < 1e-5


def test_sinkhorn_chunked_matches_jax():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    y = (rng.normal(size=(44, 6)) + 1.0).astype(np.float32)
    for chunk in (16, 64):
        ours = float(tsink.sinkhorn_loss_chunked(torch.from_numpy(x), torch.from_numpy(y),
                                                 chunk_size=chunk))
        ref = float(jsink.sinkhorn_loss_chunked(jnp.asarray(x), jnp.asarray(y),
                                                chunk_size=chunk))
        np.testing.assert_allclose(ours, ref, atol=1e-5)
