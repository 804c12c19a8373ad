"""The plain twins of K3, K4 and K5 (``flocoder_torch.ops.fused_vq``) against
the JAX package's fused VQ kernels on the CPU, where the Pallas kernels run
in interpret mode, and the port's ``VQVAE.encode_quantize_fused`` against
JAX's on the same weights (through the weight bridge). Inputs come from
numpy seeds; the convolution weights reach the port in flax layout through
the bridge's converter (HWIO → OIHW).

Tolerances (fp32): indices exact; z_q within 1e-5 for K4 and 2e-5 for K3
(a pick equal on both sides gives the same codes, summed in the same
order); the tail's intermediates within 1e-5 of the Pallas debug kernel and
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
                                 kernels.compress_tail_debug)] == [0, 0, 0]


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
