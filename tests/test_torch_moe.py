"""The port's single-device MoE (flocoder_torch.parallel.moe), which routes
by (token, k) slot, against the JAX package's one-hot (T, E, C) form
(flocoder_tpu.parallel.moe) on the same numpy logits, tokens and expert
weights.

Tolerances: the slot assignment, the keep mask and the first-choice
counts exactly (the
logits have no ties, or ties that both break to the lower expert index);
the combine weights, the mean probabilities and ``load_balance_loss``
within 1e-6; the expert output and its gradients (tokens, logits, both
expert weights) within 1e-5·max(1, |ref|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.parallel import moe as jmoe
from flocoder_torch.parallel import moe as tmoe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense(routing, T):
    """The port's routing as the JAX module's (T, E, C) dispatch and combine."""
    E, C = routing.n_experts, routing.capacity
    dispatch = np.zeros((T, E, C), np.float32)
    combine = np.zeros((T, E, C), np.float32)
    slot, keep, gates = (routing.slot.numpy(), routing.keep.numpy(),
                         routing.gates.detach().numpy())
    for t in range(T):
        for k in range(slot.shape[1]):
            if keep[t, k]:
                dispatch[t, slot[t, k] // C, slot[t, k] % C] = 1.0
                combine[t, slot[t, k] // C, slot[t, k] % C] = gates[t, k]
    return dispatch, combine


def _logits(T, E, seed, ties=False):
    logits = np.random.default_rng(seed).normal(size=(T, E)).astype(np.float32) * 2
    if ties:   # every other token has its two largest logits equal
        top = np.argsort(-logits, axis=1)
        logits[::2, top[::2, 1]] = logits[::2, top[::2, 0]]
    return logits


@pytest.mark.parametrize("T,E,K,factor,ties", [
    (37, 5, 2, 1.25, False),     # ample capacity
    (64, 4, 2, 0.5, False),      # capacity truncation: assignments dropped
    (50, 8, 1, 0.3, False),      # top-1, heavy truncation
    (40, 6, 2, 0.75, True),      # ties, broken to the lower index
])
def test_routing_matches_the_one_hot_form(T, E, K, factor, ties):
    logits = _logits(T, E, T + E, ties)
    cap = tmoe.moe_capacity(T, E, K, factor)
    assert cap == jmoe.moe_capacity(T, E, K, factor)
    jd, jc, jstats = jmoe.moe_routing(jnp.asarray(logits), K, cap)
    routing = tmoe.moe_routing(torch.from_numpy(logits), K, cap)
    d, c = _dense(routing, T)
    np.testing.assert_array_equal(d, np.asarray(jd))
    np.testing.assert_allclose(c, np.asarray(jc), rtol=0, atol=1e-6)
    if factor < 1:
        assert not routing.keep.all()
    # the density is a count over T (exact), summed in another order
    np.testing.assert_array_equal(np.rint(routing.stats["density"].numpy() * T),
                                  np.rint(np.asarray(jstats["density"]) * T))
    np.testing.assert_allclose(routing.stats["density"].numpy(),
                               np.asarray(jstats["density"]), rtol=0, atol=1e-7)
    np.testing.assert_allclose(routing.stats["prob_mean"].detach().numpy(),
                               np.asarray(jstats["prob_mean"]), rtol=0, atol=1e-6)
    assert float(routing.stats["dropped_frac"]) == pytest.approx(
        float(jstats["dropped_frac"]), abs=1e-7)
    np.testing.assert_allclose(float(tmoe.load_balance_loss(routing.stats, E)),
                               float(jmoe.load_balance_loss(jstats, E)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_expert_compute_and_gradients_match_jax(factor):
    T, E, K, d, f = 48, 4, 2, 8, 12
    rng = np.random.default_rng(9)
    flat, logits = (rng.normal(size=s).astype(np.float32) for s in ((T, d), (T, E)))
    w_up = (rng.normal(size=(E, d, 2 * f)) / np.sqrt(d)).astype(np.float32)
    w_down = (rng.normal(size=(E, f, d)) / np.sqrt(f)).astype(np.float32)
    g = rng.normal(size=(T, d)).astype(np.float32)
    cap = jmoe.moe_capacity(T, E, K, factor)

    def jloss(flat, logits, w_up, w_down):
        disp, comb, stats = jmoe.moe_routing(logits, K, cap)
        out = jmoe.moe_geglu_apply(flat, disp, comb, w_up, w_down)
        return jnp.sum(out * g) + jmoe.load_balance_loss(stats, E), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in (flat, logits, w_up, w_down)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (flat, logits, w_up, w_down)]
    routing = tmoe.moe_routing(leaves[1], K, cap)
    out = tmoe.moe_geglu_apply(leaves[0], routing, leaves[2], leaves[3])
    loss = (out * torch.from_numpy(g)).sum() + tmoe.load_balance_loss(routing.stats, E)
    grads = torch.autograd.grad(loss, leaves)
    ref = np.asarray(jout)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
    for name, a, r in zip(("flat", "logits", "w_up", "w_down"), grads, jgrads):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(r).max()), err_msg=name)
