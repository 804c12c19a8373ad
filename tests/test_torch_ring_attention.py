"""The port's ring attention (flocoder_torch/parallel/ring_attention.py) on 2
gloo ranks, a 1×2 mesh of the model axis, against the JAX package's
``ring_attention_replicated`` under ``shard_map`` on 2 devices of the
virtual CPU mesh (and its ``make_ring_self_attention`` for the
sequence-sharded form), on the same numpy inputs: the forward and the
gradients of sum(out·w) for q, k, v. Cases: head width 8 at 2 heads; v
wider than q and k (the codec's non-local attention: one head, v at full
width); bf16 inputs; the degenerate ring of one (plain attention); the
sharded form; and a token count the ring does not divide, which raises.

Tolerances: fp32 forward 1e-5 absolute; gradients rtol 5e-4, atol 5e-5
(the JAX ring test's own); bf16 2e-2 · max(1, |ref|). The ring hops S
times a forward and S times a backward, all-gathers once a forward (the
output) and three times a backward (dq, dk, dv, after the loop): no K, V,
dK or dV is gathered inside it. The per-rank backward FLOPs
(``FlopCounterMode``) at S = 2 stay under 0.65 of plain attention's, the
JAX test's rule (``tests/test_ring_attention.py``) for the split of the
O(n²) work.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flocoder_tpu.parallel.mesh import P, make_mesh, pmean_typed, shard_map
from flocoder_tpu.parallel.ring_attention import (make_ring_self_attention,
                                                  ring_attention_replicated)
from test_torch_parallel_ranks import ring_op_rank, start_ranks

S = 2


def _case(seed, b=2, n=16, h=2, d=8, dv=None, dtype="float32", axis_size=S,
          kind="replicated"):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((b, n, h, dv or d)).astype(np.float32)
    w = rng.standard_normal((b, n, h, dv or d)).astype(np.float32)
    return dict(q=q, k=k, v=v, w=w, dtype=dtype, axis_size=axis_size, kind=kind)


CASES = {"fp32": _case(0), "dv_wider": _case(1, n=32, h=1, d=4, dv=8),
         "bf16": _case(2, dtype="bfloat16"), "one_rank": _case(3, axis_size=1),
         "sharded": _case(4, kind="sharded"), "not_dividing": _case(5, n=15)}


def _jax_ring(c):
    """(out, (dq, dk, dv)) of the JAX ring on the case's inputs."""
    dt = getattr(jnp, c["dtype"])
    q, k, v = (jnp.asarray(c[n], dt) for n in "qkv")
    w = jnp.asarray(c["w"])

    def loss_of(ring):
        def loss(q_, k_, v_):
            out = ring(q_, k_, v_)
            return jnp.sum(out.astype(jnp.float32) * w), out
        return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)

    if c["kind"] == "sharded":
        (_, out), grads = jax.jit(loss_of(make_ring_self_attention(MESH)))(q, k, v)
        return out, grads
    if c["axis_size"] == 1:     # plain attention, no axis to bind
        (_, out), grads = loss_of(
            lambda *a: ring_attention_replicated(*a, "model", 1, None))(q, k, v)
        return out, grads

    def body(q_, k_, v_):       # gradients inside the shard_map, as the train steps take them
        (_, out), grads = loss_of(
            lambda *a: ring_attention_replicated(*a, "model", S, None))(q_, k_, v_)
        names = ("model", "data")
        return pmean_typed(out, names), pmean_typed(grads, names)

    f = shard_map(body, mesh=MESH, in_specs=(P(), P(), P()),
                  out_specs=(P(), (P(), P(), P())), check_rep=False)
    return jax.jit(f)(q, k, v)


MESH = make_mesh(n_data=1, n_model=S, devices=jax.devices()[:S])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cases in one 2-rank world, the JAX references computed beside it."""
    flop_qkv = [np.random.default_rng(9 + i).standard_normal((1, 256, 2, 16))
                .astype(np.float32) for i in range(3)]
    ranks = start_ranks(ring_op_rank, S, tmp_path_factory.mktemp("ring"),
                        list(CASES.values()), flop_qkv)
    refs = {name: _jax_ring(c) for name, c in CASES.items() if name != "not_dividing"}
    res = ranks.join()
    return {"refs": refs, "res": res,
            "cases": {name: [r["cases"][i] for r in res] for i, name in enumerate(CASES)}}


def _chunks(name, ours, i=None):
    """The whole tensor of the ranks' results: the same on each rank, or
    with the sharded form their token chunks side by side."""
    pick = (lambda r: r["out"]) if i is None else (lambda r: r["grads"][i])
    if CASES[name]["kind"] == "sharded":
        return np.concatenate([pick(r) for r in ours], axis=1)
    for r in ours[1:]:
        np.testing.assert_array_equal(pick(r), pick(ours[0]))    # whole on every rank
    return pick(ours[0])


@pytest.mark.parametrize("name", ["fp32", "dv_wider", "bf16", "one_rank", "sharded"])
def test_ring_forward_and_gradients_match_jax(runs, name):
    ours = runs["cases"][name]
    out_ref, grads_ref = runs["refs"][name]
    bf16 = CASES[name]["dtype"] == "bfloat16"
    out_ref = np.asarray(out_ref, np.float32)
    if bf16:
        assert ours[0]["dtype"] == "torch.bfloat16"
        assert ours[0]["grad_dtypes"] == ["torch.bfloat16"] * 3
        np.testing.assert_allclose(_chunks(name, ours), out_ref, rtol=0,
                                   atol=2e-2 * max(1.0, np.abs(out_ref).max()))
    else:
        np.testing.assert_allclose(_chunks(name, ours), out_ref, rtol=0, atol=1e-5)
    for i, g_ref in enumerate(grads_ref):
        g_ref = np.asarray(g_ref, np.float32)
        if bf16:
            np.testing.assert_allclose(_chunks(name, ours, i), g_ref, rtol=0,
                                       atol=2e-2 * max(1.0, np.abs(g_ref).max()))
        else:
            np.testing.assert_allclose(_chunks(name, ours, i), g_ref, rtol=5e-4, atol=5e-5)


def test_ring_hops_and_gathers(runs):
    """S hops a forward and S a backward; one all-gather a forward and three
    a backward, none inside the loop; none and no hop for the ring of one
    and none for the sharded form."""
    for name, per_rank in runs["cases"].items():
        for r in per_rank:
            if name == "not_dividing":
                assert "divisible" in r["error"]
            elif name == "one_rank":
                assert r["hops"] == [0, 0] and r["gathers"] == [0, 0]
            elif name == "sharded":
                assert r["hops"] == [S, S] and r["gathers"] == [0, 0]
            else:
                assert r["hops"] == [S, S] and r["gathers"] == [1, 3], name


def test_ring_backward_flops_split_over_the_ranks(runs):
    for r in runs["res"]:
        assert 0 < r["flops"]["ring"] < 0.65 * r["flops"]["plain"], r["flops"]


def test_ring_mesh_layout(runs):
    """The 1×2 mesh: rank r at data 0, model r (the JAX mesh's layout);
    both ranks take batch rank 0's rows and seed."""
    lays = [r["layout"] for r in runs["res"]]
    for rank, lay in enumerate(lays):
        assert lay["dims"] == ("data", "model") and lay["shape"] == (1, S)
        assert lay["coord"] == [0, rank] and lay["model_rank"] == rank
        assert lay["batch_rank"] == 0 and lay["n_batch"] == 1
    assert lays[0]["seed"] == lays[1]["seed"]
