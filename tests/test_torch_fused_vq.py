"""The plain twins of K3, K4 and K5 (``flocoder_torch.ops.fused_vq``) against
the JAX package's fused VQ kernels on the CPU, where the Pallas kernels run
in interpret mode, and the port's ``VQVAE.encode_quantize_fused`` against
JAX's on the same weights (through the weight bridge). Inputs come from
numpy seeds; the convolution weights reach the port in flax layout through
the bridge's converter (HWIO → OIHW).

Tolerances (fp32): indices exact; z_q within 1e-5 for K4 and 2e-5 for K3
(a pick equal on both sides gives the same codes, summed in the same
order); with bf16 h (K3's bf16 case) indices exact and z_q equal in bf16; the tail's intermediates within 1e-5 of the Pallas debug kernel and
of ``benchmarks/fused_probe.py``'s fp64 oracle. Codebooks are scaled to the
spread of what they quantize, so that the picks spread over the codes.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.models import codecs as jcodecs
from flocoder_tpu.ops.pallas.fused_vq import fused_compress_tail_vq as jax_tail_vq
from flocoder_tpu.ops.pallas.fused_vq import fused_compress_vq as jax_compress_vq
from flocoder_tpu.ops.rvq import RVQState as JaxRVQState
from flocoder_tpu.training.checkpoint import unflatten_tree
from flocoder_torch.models import codecs as tcodecs
from flocoder_torch.models.layers import init_params
from flocoder_torch.ops import fused_vq as fvq
from flocoder_torch.ops.kernels import fused_vq as kernels
from flocoder_torch.training.checkpoint import VQVAE_PREFIXES, _from_jax, to_jax_flat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; one torch thread each
    keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probe():
    spec = importlib.util.spec_from_file_location(
        "fc_fused_probe", os.path.join(ROOT, "benchmarks", "fused_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tail_inputs(seed, B, H, W, Din, D):
    """NHWC h and the tail's weights in flax layout (w1 (Din, D), conv HWIO)."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(h=f(B, H, W, Din), w1=f(Din, D, scale=0.3), b1=f(D, scale=0.1),
                gs=(1 + f(D, scale=0.1)), gb=f(D, scale=0.1),
                cw=f(3, 3, D, D, scale=0.3), cb_=f(D, scale=0.1))


def _port_tail_args(a):
    """The same tensors as the port takes them: OIHW conv weights through
    the bridge's converter."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa: E731
    return (t(a["h"]), t(_from_jax(a["w1"][None, None], "conv")), t(a["b1"]),
            t(a["gs"]), t(a["gb"]), t(_from_jax(a["cw"], "conv")), t(a["cb_"]))


@pytest.mark.parametrize("N,Din,D,L,K", [(300, 16, 4, 3, 8), (77, 16, 4, 3, 8)])
def test_compress_vq_twin_matches_pallas(N, Din, D, L, K):
    rng = np.random.default_rng(N)
    z = rng.standard_normal((N, Din)).astype(np.float32)
    w = (rng.standard_normal((Din, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(D) * 0.1).astype(np.float32)
    spread = float((z @ w + b).std())
    cb = (rng.standard_normal((L, K, D)) * spread).astype(np.float32)
    zq_ref, idx_ref = jax_compress_vq(*map(jnp.asarray, (z, w, b, cb)), tile_n=128)
    zq, idx = fvq.fused_compress_vq(*map(torch.from_numpy, (z, w, b, cb)))
    assert idx.dtype == torch.int32 and zq.shape == (N, D) and idx.shape == (N, L)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    assert len(np.unique(idx.numpy()[:, 0])) > K // 2
    np.testing.assert_allclose(zq.numpy(), np.asarray(zq_ref), atol=1e-5)


@pytest.mark.parametrize("D,groups", [(4, 2), (3, 1)])
def test_compress_tail_vq_twin_matches_pallas(D, groups):
    B, H, W, Din, L, K = 3, 8, 8, 16, 3, 8
    a = _tail_inputs(D, B, H, W, Din, D)
    args = _port_tail_args(a)
    spread = float(fvq.compress_tail_debug_plain(*args, groups)[2].std())
    cb = (np.random.default_rng(7).standard_normal((L, K, D)) * spread).astype(np.float32)
    zq_ref, idx_ref = jax_tail_vq(
        *map(jnp.asarray, (a["h"], a["w1"], a["b1"], a["gs"], a["gb"], a["cw"],
                           a["cb_"], cb)), groups=groups, tile_b=2)
    zq, idx = fvq.fused_compress_tail_vq(*args, torch.from_numpy(cb), groups)
    assert zq.shape == (B, H, W, D) and idx.shape == (B, H, W, L)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_allclose(zq.numpy(), np.asarray(zq_ref), atol=2e-5)


@pytest.mark.parametrize("D,groups", [(4, 2), (3, 1)])
def test_compress_tail_vq_twin_takes_bf16_h_as_pallas_does(D, groups):
    """K3 on bf16 activations (a bf16 codec's): the Pallas kernel widens h
    to fp32 in its body and writes z_q in h's dtype; the twin widens h and
    casts z_q, so from the same bf16 h the picks are equal and z_q is equal
    in bf16. The twin on bf16 h is the twin on h widened, z_q rounded."""
    B, H, W, Din, L, K = 3, 8, 8, 16, 3, 8
    a = _tail_inputs(D + 10, B, H, W, Din, D)
    hb = jnp.asarray(a["h"], jnp.bfloat16)
    args = list(_port_tail_args(a))
    args[0] = torch.from_numpy(np.array(hb.astype(jnp.float32))).to(torch.bfloat16)
    spread = float(fvq.compress_tail_debug_plain(args[0].float(), *args[1:], groups)[2].std())
    cb = (np.random.default_rng(8).standard_normal((L, K, D)) * spread).astype(np.float32)
    zq_ref, idx_ref = jax_tail_vq(
        hb, *map(jnp.asarray, (a["w1"], a["b1"], a["gs"], a["gb"], a["cw"], a["cb_"], cb)),
        groups=groups, tile_b=2)
    assert zq_ref.dtype == jnp.bfloat16
    zq, idx = fvq.fused_compress_tail_vq(*args, torch.from_numpy(cb), groups)
    assert zq.dtype == torch.bfloat16 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    assert len(np.unique(idx.numpy()[..., 0])) > K // 2
    np.testing.assert_array_equal(zq.float().numpy(), np.asarray(zq_ref.astype(jnp.float32)))
    zq32, idx32 = fvq.fused_compress_tail_vq(args[0].float(), *args[1:],
                                             torch.from_numpy(cb), groups)
    assert torch.equal(idx32, idx) and torch.equal(zq32.to(torch.bfloat16), zq)


def test_bf16_wrapper_takes_bf16_h_alone():
    """K3's bf16 case takes bf16 h and float32 weights and codebooks, as
    the JAX call passes them; bf16 weights raise a TypeError, and so does
    fp32 h, which is the fp32 case's. Nothing launches."""
    ins = list(_wrapper_inputs(4))
    k = kernels.fused_compress_tail_vq_bf16
    with pytest.raises(TypeError, match="w1 has dtype torch.bfloat16; it takes float32"):
        k(ins[0].bfloat16(), ins[1].bfloat16(), *ins[2:8], groups=2)
    with pytest.raises(TypeError, match="h has dtype torch.float32; it takes bfloat16"):
        k(*ins[:8], groups=2)
    with pytest.raises(ValueError, match="not a CUDA device"):
        k(ins[0].bfloat16(), *ins[1:8], groups=2)
    assert k.launches == 0 and kernels.fused_compress_tail_vq.launches == 0


def test_compress_tail_debug_twin_matches_pallas_and_oracle():
    a = _tail_inputs(11, 2, 8, 8, 16, 4)
    probe = _probe()
    ref = probe._dbg_tail(a["h"], a["w1"], a["b1"], a["gs"], a["gb"], a["cw"], a["cb_"],
                          groups=2)
    oracle = probe._tail_oracle(a["h"], a["w1"], a["b1"], a["gs"], a["gb"], a["cw"],
                                a["cb_"], groups=2)
    args = _port_tail_args(a)
    ours = fvq.compress_tail_debug(*args, 2)
    ours64 = fvq.compress_tail_oracle(*args, 2)
    for name, o, o64, r, r64 in zip(("y1", "y2", "out"), ours, ours64, ref, oracle):
        assert o.shape == (128, 4)
        np.testing.assert_allclose(o.numpy(), r, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(o.numpy(), r64, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(o64.numpy(), r64, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("kernel", ["compress_vq", "compress_tail_vq"])
def test_nan_token_matches_the_fused_jax_reference(kernel):
    """A NaN token has a NaN distance to every code, so the Pallas kernels'
    first-minimum one-hot is all zero: each level adds nothing (z_q 0) and
    records index 0. The twins do the same; every other token is unchanged.
    In the tail a NaN pixel makes its whole image NaN (GroupNorm's per-image
    statistics), so every token of that image is such a token."""
    L, K, D = 3, 8, 4
    if kernel == "compress_vq":
        rng = np.random.default_rng(5)
        z = rng.standard_normal((8, 16)).astype(np.float32)
        z[5] = np.nan
        w = (rng.standard_normal((16, D)) * 0.3).astype(np.float32)
        b = (rng.standard_normal(D) * 0.1).astype(np.float32)
        cb = (rng.standard_normal((L, K, D)) * float(np.nanstd(z @ w + b))).astype(np.float32)
        zq_ref, idx_ref = jax_compress_vq(*map(jnp.asarray, (z, w, b, cb)), tile_n=128)
        zq, idx = fvq.fused_compress_vq(*map(torch.from_numpy, (z, w, b, cb)))
        bad = np.zeros(8, bool)
        bad[5] = True
    else:
        a = _tail_inputs(6, 2, 4, 4, 16, D)
        a["h"][1, 2, 3] = np.nan
        args = _port_tail_args(a)
        spread = float(fvq.compress_tail_debug_plain(*args, 2)[2][:16].std())
        cb = (np.random.default_rng(8).standard_normal((L, K, D)) * spread).astype(np.float32)
        zq_ref, idx_ref = jax_tail_vq(
            *map(jnp.asarray, (a["h"], a["w1"], a["b1"], a["gs"], a["gb"], a["cw"],
                               a["cb_"], cb)), groups=2, tile_b=2)
        zq, idx = fvq.fused_compress_tail_vq(*args, torch.from_numpy(cb), 2)
        bad = np.zeros((2, 4, 4), bool)
        bad[1] = True
    zq_ref, idx_ref = np.asarray(zq_ref), np.asarray(idx_ref)
    assert not zq_ref[bad].any() and not idx_ref[bad].any()
    np.testing.assert_array_equal(idx.numpy(), idx_ref)
    np.testing.assert_allclose(zq.numpy(), zq_ref, atol=2e-5)
    assert len(np.unique(idx_ref[~bad][..., 0])) > 1


def test_encode_quantize_fused_matches_jax():
    """A small codec without attention (as the JAX package's own test):
    the port's fused encode and JAX's on the same weights give the same
    picks, and the port's picks are its unfused quantize's."""
    kw = dict(in_channels=3, hidden_channels=8, num_downsamples=2, internal_dim=16,
              vq_embedding_dim=4, codebook_levels=3, vq_num_embeddings=16,
              use_attention=False)
    tc = init_params(tcodecs.VQVAE(**kw), torch.Generator().manual_seed(3))
    x = np.random.default_rng(2).standard_normal((5, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        tc.vq.codebooks.mul_(float(tc.encode(torch.from_numpy(x)).std()) / 0.02)
    params = unflatten_tree({k: jnp.asarray(v) for k, v in
                             to_jax_flat(tc, VQVAE_PREFIXES).items()})
    params["vq"] = JaxRVQState(**params["vq"])
    jc = jcodecs.VQVAE(**kw)
    zq_ref, idx_ref = jax.jit(lambda p, x: jc.encode_quantize_fused(p, x, tile_b=2))(
        params, jnp.asarray(x))
    with torch.inference_mode():
        zq, idx = tc.encode_quantize_fused(torch.from_numpy(x))
        _, idx_unfused, _, _ = tc.quantize(tc.encode(torch.from_numpy(x)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(idx.numpy(), idx_unfused.numpy())
    assert len(np.unique(idx.numpy()[..., 0])) > 4
    np.testing.assert_allclose(zq.numpy(), np.asarray(zq_ref), atol=2e-5)


def test_picks_criterion():
    """check_picks accepts picks equal to the reference's and differing
    picks whose fp64 distance ties the best one, and refuses a worse pick."""
    cb = torch.tensor([[[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0]]], dtype=torch.float64)
    x = torch.tensor([[0.5, 0.0], [0.1, 0.0]], dtype=torch.float64)
    best = torch.tensor([[0], [0]])
    tie = torch.tensor([[1], [0]])      # x[0] is as far from code 1 as from 0
    worse = torch.tensor([[0], [1]])
    assert fvq.check_picks(best, best, fvq.rvq_pick_gaps(x, cb, best))["ok"]
    res = fvq.check_picks(tie, best, fvq.rvq_pick_gaps(x, cb, tie))
    assert res["ok"] and res["differ"] == 1 and res["tokens"] == 2
    assert not fvq.check_picks(worse, best, fvq.rvq_pick_gaps(x, cb, worse))["ok"]


def _kernel_calls(h, w1, b1, gs, gb, cw, cbias, cb, z, w, b):
    return [lambda: kernels.fused_compress_tail_vq(h, w1, b1, gs, gb, cw, cbias, cb, 1),
            lambda: kernels.compress_tail_debug(h, w1, b1, gs, gb, cw, cbias, 1),
            lambda: kernels.fused_compress_vq(z, w, b, cb)]


def _wrapper_inputs(D, dtype=torch.float32):
    t = lambda *s: torch.zeros(*s, dtype=dtype)  # noqa: E731
    return (t(2, 4, 4, 8), t(D, 8, 1, 1), t(D), t(D), t(D), t(D, D, 3, 3), t(D),
            t(2, 5, D), t(10, 8), t(8, D), t(D))


@pytest.mark.parametrize("case,error,match", [
    ("cpu", ValueError, "not a CUDA device"),
    ("bf16", TypeError, "float32"),
    ("D>16", ValueError, "D=17"),
    ("D not built", ValueError, "ROADMAP.md"),
])
def test_wrappers_raise_and_cpu_calls_launch_nothing(case, error, match):
    D = {"D>16": 17, "D not built": 5}.get(case, 4)
    ins = _wrapper_inputs(D, torch.bfloat16 if case == "bf16" else torch.float32)
    for call in _kernel_calls(*ins):
        with pytest.raises(error, match=match):
            call()
    ins = _wrapper_inputs(4)
    fvq.fused_compress_tail_vq(*ins[:8], groups=2)
    fvq.compress_tail_debug(*ins[:7], groups=2)
    fvq.fused_compress_vq(*ins[8:], ins[7])
    assert [k.launches for k in (kernels.fused_compress_vq, kernels.fused_compress_tail_vq,
                                 kernels.fused_compress_tail_vq_bf16,
                                 kernels.compress_tail_debug)] == [0, 0, 0, 0]


def test_wrapper_refuses_groups_and_oversized_maps():
    """groups that do not divide D raise before any launch. The C entry
    alone sizes a block's shared memory: its code for a block over the limit
    is raised as a ValueError, and only a launch it reports counts (the
    real oversized map is held on the card in test_torch_kernels_gpu.py)."""
    ins = list(_wrapper_inputs(4))
    with pytest.raises(ValueError, match="groups=3"):
        kernels.fused_compress_tail_vq(*ins[:8], groups=3)
    k = kernels.CompressTailDebug()
    with pytest.raises(ValueError, match="256x256x4 map .* shared memory"):
        kernels._launch(k, lambda *a: -1, [], "an image's 256x256x4 map")
    with pytest.raises(RuntimeError, match="cudaError 1"):
        kernels._launch(k, lambda *a: 1, [], "an image's 4x4x4 map")
    assert k.launches == 0
    kernels._launch(k, lambda *a: 0, [], "an image's 4x4x4 map")
    assert k.launches == 1


# ---- the Hopper kernels' arithmetic, emulated in torch (csrc/fused_vq.cu)

def _owner(layout, y):
    owners = [rank for rank, (r0, r1, _, _) in enumerate(layout) if r0 <= y < r1]
    assert len(owners) == 1, (y, layout)
    return owners[0]


@pytest.mark.parametrize("cs", kernels.CLUSTER_SIZES)
def test_band_plan_matches_brute_force(cs):
    """Every H, W ≤ 24 and every cluster size: each row is owned by one block; a band's halo rows
    come from the blocks that own them, as the last row of a full band
    above and the first row of the band below (the kernel reads those
    places), or are the image's edge; blocks with no rows come last and
    exchange nothing; the lanes are the most (a power of two up to 32) for
    which a full band's tokens fit the block's threads in one pass, each
    lane group taking TOKENS_PER_GROUP tokens."""
    T = kernels.TAIL_THREADS * kernels.TOKENS_PER_GROUP
    for H in range(1, 25):
        for W in range(1, 25):
            got, rows, lanes = kernels.plan_bands(H, W, cs)
            assert got == cs and rows * cs >= H and (rows - 1) * cs < H
            layout = kernels.band_layout(H, cs, rows)
            for y in range(H):
                _owner(layout, y)
            live = [r0 < r1 for r0, r1, _, _ in layout]
            assert live == sorted(live, reverse=True)
            for rank, (r0, r1, above, below) in enumerate(layout):
                if r0 == r1:
                    assert (above, below) == (-1, -1)
                    continue
                if r0 == 0:
                    assert above == -1
                else:
                    assert above == _owner(layout, r0 - 1) == rank - 1
                    a0, a1 = layout[above][:2]
                    assert a1 == r0 and a1 - a0 == rows
                if r1 == H:
                    assert below == -1
                else:
                    assert below == _owner(layout, r1) == rank + 1
                    assert layout[below][0] == r1
            assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
            assert lanes == 1 or lanes * rows * W <= T
            assert lanes == 32 or 2 * lanes * rows * W > T


def test_band_plan_default_and_refusals():
    """By default the most blocks an image for which the blocks come to at
    most two an SM, up to 8 and no more than the map's rows: 8 at the
    pre-encode batch of 32 on 132 SMs and at the probe's batch of 4, 4 at
    batch 64."""
    assert kernels.plan_bands(16, 16, batch=32, sms=132)[0] == 8
    assert kernels.plan_bands(16, 16, batch=4, sms=132)[0] == 8
    assert kernels.plan_bands(16, 16, batch=64, sms=132)[0] == 4
    assert kernels.plan_bands(16, 16, batch=200, sms=132)[0] == 1
    assert [kernels.plan_bands(H, 4)[0] for H in (1, 2, 3, 5)] == [1, 2, 4, 8]
    for bad in (0, 3, 16):
        with pytest.raises(ValueError, match="cluster"):
            kernels.plan_bands(16, 16, bad)


def _first_min(dist):
    """A serial scan with a strict <, as the kernels before the lane split:
    the first minimum; a NaN never wins; 0 when nothing is below +inf."""
    d = torch.where(torch.isnan(dist), torch.full_like(dist, float("inf")), dist)
    idx = d.argmin(1)
    return torch.where(torch.isinf(d.min(1).values) & (d.min(1).values > 0),
                       torch.zeros_like(idx), idx)


CHAINS = 2   # kChains in csrc/fused_vq.cu


def _lane_split_pick(dist, g):
    """group_search's pick from (N, K) fp32 distances with g lanes a token:
    the level padded to a multiple of CHAINS·g with NaN codes; lane j's
    running minima u = 0..CHAINS-1 over codes j + u·g + CHAINS·g·m (a strict
    <), merged in u order, then the xor-shuffle merge over the group; a pair
    replaces another only if its distance is smaller, or equal with a
    smaller index; no code below +inf gives index 0."""
    N, K = dist.shape
    Kp = -(-K // (CHAINS * g)) * (CHAINS * g)
    pad = torch.cat([dist, torch.full((N, Kp - K), float("nan"))], 1)
    lanes = pad.reshape(N, Kp // (CHAINS * g), CHAINS, g)   # [m, u, j]
    code = torch.arange(Kp).reshape(Kp // (CHAINS * g), CHAINS, g)
    no = torch.iinfo(torch.int64).max
    best = torch.full((N, CHAINS, g), float("inf"))
    bi = torch.full((N, CHAINS, g), no)
    for m in range(lanes.shape[1]):                          # each chain in code order
        take = lanes[:, m] < best
        best = torch.where(take, lanes[:, m], best)
        bi = torch.where(take, code[m].expand(N, CHAINS, g), bi)

    def merge(b, i, ob, oi):
        take = (ob < b) | ((ob == b) & (oi < i))
        return torch.where(take, ob, b), torch.where(take, oi, i)

    b, i = best[:, 0], bi[:, 0]
    for u in range(1, CHAINS):
        b, i = merge(b, i, best[:, u], bi[:, u])
    off = 1
    while off < g:
        perm = torch.arange(g) ^ off
        b, i = merge(b, i, b[:, perm], i[:, perm])
        off *= 2
    assert (i == i[:, :1]).all()                             # every lane holds the pick
    i = i[:, 0]
    return torch.where(i == no, torch.zeros_like(i), i)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 32])
def test_lane_split_merge_is_the_first_minimum(g):
    """Random distances, exact ties (few distinct values: many equal
    minima), and NaN rows (some NaN, all NaN): the lane-split pick equals
    torch.argmin's first minimum where there is no NaN, and the serial
    scan's pick everywhere."""
    gen = torch.Generator().manual_seed(g)
    for K in (96, 13, 512):
        rand = torch.randn(300, K, generator=gen)
        ties = torch.randint(0, 4, (300, K), generator=gen).float()
        nan = torch.randn(300, K, generator=gen)
        nan[torch.rand(300, K, generator=gen) < 0.3] = float("nan")
        nan[::7] = float("nan")
        nan[3, :] = float("inf")
        for dist in (rand, ties):
            assert torch.equal(_lane_split_pick(dist, g), dist.argmin(1))
        assert torch.equal(_lane_split_pick(nan, g), _first_min(nan))
        assert not _lane_split_pick(nan, g)[::7].any()


def test_division_by_reciprocal_is_exact():
    """div_by in csrc/fused_vq.cu: a / b as trunc(a · fp32(1/b)) corrected
    by one step each way equals the integer quotient for 0 ≤ a < 2^22."""
    rng = np.random.default_rng(0)
    for b in list(range(1, 200)) + list(rng.integers(200, 1 << 16, 300)):
        a = np.concatenate([np.arange(0, 40 * b + 5),
                            rng.integers(0, 1 << 22, 500)]).astype(np.int64)
        inv = np.float32(1.0) / np.float32(b)
        q = np.trunc(a.astype(np.float32) * inv).astype(np.int64)
        r = a - q * b
        q = q + (r >= b) - (r < 0)
        np.testing.assert_array_equal(q, a // b)


def _band_stats(y, groups, cs, rows):
    """The kernel's GroupNorm statistics of one image's map y (H, W, D) in
    fp32: each band's group sums and M2 around the band's own mean, merged
    across the cluster (Chan; the kernel sums in a fixed shuffle tree, here
    in rank order); returns per-channel (mean, rstd)."""
    H, W, D = y.shape
    gsz = D // groups
    parts = []
    for r0, r1, _, _ in kernels.band_layout(H, cs, rows):
        yb = y[r0:r1].reshape(-1, groups, gsz)
        n = float(yb.shape[0] * gsz)
        s = yb.sum((0, 2))
        m2 = ((yb - s[None, :, None] / n) ** 2).sum((0, 2)) if n else torch.zeros(groups)
        parts.append((n, s, m2))
    n = sum(p[0] for p in parts)
    total = torch.zeros(groups)
    for _, s, _ in parts:
        total = total + s
    mean = total / n
    m2 = torch.zeros(groups)
    for nq, s, mq in parts:
        if nq:
            m2 = m2 + mq + nq * (s / nq - mean) ** 2
    rstd = 1.0 / torch.sqrt(m2 / n + 1e-5)
    return mean.repeat_interleave(gsz), rstd.repeat_interleave(gsz)


@pytest.mark.parametrize("cs", kernels.CLUSTER_SIZES)
def test_cluster_groupnorm_merge_matches_oracle(cs):
    """At the pre-encode shape (16×16×128 → D=4, two groups) at batch 4:
    the band partials merged in rank order give GroupNorm's output within
    1e-6 of compress_tail_oracle's (the projection taken from the oracle and
    rounded to fp32, so that only the statistics are compared)."""
    g = torch.Generator().manual_seed(cs)
    h, tail, _ = fvq.random_tail_inputs(g, 4, 16, 16, 128, 4, 1, 1, 2)
    y1, y2, _ = fvq.compress_tail_oracle(h, *tail, 2)
    y1 = y1.reshape(4, 16, 16, 4)
    rows = kernels.plan_bands(16, 16, cs)[1]
    for b in range(4):
        mean, rstd = _band_stats(y1[b].float(), 2, cs, rows)
        ours = torch.nn.functional.silu((y1[b].float() - mean) * rstd * tail[2] + tail[3])
        err = (ours.double() - y2.reshape(4, 16, 16, 4)[b]).abs().max().item()
        assert err < 1e-6, (cs, b, err)


def _emulate_tail(h, w1, b1, gs, gb, cw, cbias, codebooks, groups, cs):
    """K3's bands in torch, fp32: each band projected, the statistics merged
    across the cluster, SiLU, the band padded with the neighbours' rows
    where band_layout names them (the last row of a full band above, the
    first row of the band below) and zeros elsewhere, a valid 3×3
    convolution, and the lane-split search. Returns (out, idx)."""
    B, H, W, Din = h.shape
    D = w1.shape[0]
    cs, rows, lanes = kernels.plan_bands(H, W, cs)
    layout = kernels.band_layout(H, cs, rows)
    out = torch.empty(B, H, W, D)
    for b in range(B):
        y1 = h[b] @ w1.reshape(D, Din).T + b1
        mean, rstd = _band_stats(y1, groups, cs, rows)
        y2 = torch.nn.functional.silu((y1 - mean) * rstd * gs + gb)
        for r0, r1, above, below in layout:
            if r0 == r1:
                continue
            pad = torch.zeros(rows + 2, W + 2, D)
            pad[1:1 + r1 - r0, 1:W + 1] = y2[r0:r1]
            if above >= 0:
                pad[0, 1:W + 1] = y2[layout[above][0]:layout[above][1]][rows - 1]
            if below >= 0:
                pad[r1 - r0 + 1, 1:W + 1] = y2[layout[below][0]]
            conv = torch.nn.functional.conv2d(pad.permute(2, 0, 1)[None], cw, cbias)
            out[b, r0:r1] = conv[0, :, :r1 - r0].permute(1, 2, 0)
    r = out.reshape(-1, D)
    picks = []
    for cb in codebooks:
        dist = (r * r).sum(1, keepdim=True) + (cb * cb).sum(1)[None] - 2.0 * (r @ cb.T)
        i = _lane_split_pick(dist, lanes)
        r = r - cb[i]
        picks.append(i)
    return out, torch.stack(picks, 1).reshape(B, H, W, -1)


@pytest.mark.parametrize("H,W,cs", [(16, 16, 8), (16, 16, 4), (3, 5, 8), (5, 7, 4),
                                    (1, 1, 8), (20, 20, 2), (7, 3, 1)])
def test_band_emulation_matches_twin_and_oracle(H, W, cs):
    """The band decomposition (plan, layout, halos, statistics, lane-split
    search) reproduces the tail: its 3×3 output within 1e-5·max(1, |ref|) of
    the fp64 oracle, and picks equal to the twin's or ε-optimal."""
    g = torch.Generator().manual_seed(H * 100 + W)
    h, tail, cb = fvq.random_tail_inputs(g, 2, H, W, 32, 4, 3, 24, 2)
    out, idx = _emulate_tail(h, *tail, cb, 2, cs)
    ref64 = fvq.compress_tail_oracle(h, *tail, 2)[2]
    err = (out.reshape(-1, 4).double() - ref64).abs().max().item()
    assert err < 1e-5 * max(1.0, ref64.abs().max().item()), err
    zq_ref, idx_ref = fvq.fused_compress_tail_vq_plain(h, *tail, cb, 2)
    res = fvq.check_picks(idx, idx_ref, fvq.rvq_pick_gaps(ref64, cb, idx))
    assert res["ok"], res
