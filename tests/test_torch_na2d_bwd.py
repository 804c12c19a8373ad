"""The NA2D backward of the port against the JAX package's.

- The plain twin of K2 (``na2d_bwd_banded``) and torch autograd through
  ``na2d_banded`` against ``jax.grad`` of ``na2d_pallas`` (its hand-written
  backward, run in interpret mode as tests/test_pallas_na2d.py runs it) and
  of the JAX ``na2d_banded``, for q, k and v: a ragged map, a map smaller
  than the window, and 16²×(8·16).
- K2's own algorithm (per 4×4 query patch: exact softmax over the patch's
  key union, dq, the log-sum-exp and δ = g·o; then per 4×4 key patch: the
  union of its keys' query ranges in chunks), emulated in numpy, against
  the same gradients; the closed form of its query ranges (``q_lo``/``q_hi``
  in csrc/na2d_mma.cuh) and its second pass's launch plan against brute
  force.
- The wiring on the card: ``na2d`` of a tensor that is not on the CPU goes
  through ``NA2DFunction`` (K1 forward, K2 backward), so its output has a
  gradient. The kernels themselves run only on the card
  (tests/test_torch_kernels_gpu.py).

Tolerance 1e-5 absolute in fp32: the gradients are of magnitude ~1, and
both sides take the softmax in fp32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.ops.neighborhood_attention import na2d_banded as jax_banded
from flocoder_tpu.ops.pallas.na2d import na2d_pallas
from flocoder_torch.ops import neighborhood_attention as tna
from flocoder_torch.ops.kernels import na2d as kna


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; one torch thread each
    keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5

# (B, H, W, C, kernel_size, heads)
SHAPES = [
    (1, 17, 13, 16, 7, 2),   # ragged: no tile divides 17 or 13
    (2, 5, 6, 16, 7, 2),     # smaller than the window: ks clamps to 5
    (1, 16, 16, 128, 7, 8),  # 16² with 8 heads of 16
]


def _inputs(shape, seed):
    B, H, W, C = shape[:4]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, W, C)).astype(np.float32) for _ in range(4)]


def _jax_grads(fn, q, k, v, g, ks, heads):
    def loss(q, k, v):
        return jnp.sum(fn(q, k, v) * g)
    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax_grad(shape):
    ks, heads = shape[4:]
    q, k, v, g = _inputs(shape, 0)
    pallas = _jax_grads(lambda a, b, c: na2d_pallas(a, b, c, ks, heads, None),
                        q, k, v, g, ks, heads)
    banded = _jax_grads(lambda a, b, c: jax_banded(a, b, c, kernel_size=ks,
                                                   heads=heads),
                        q, k, v, g, ks, heads)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tna.na2d(tq, tk, tv, kernel_size=ks, heads=heads)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    twin = tna.na2d_bwd_banded(tq.detach(), tk.detach(), tv.detach(),
                               out.detach(), torch.from_numpy(g),
                               kernel_size=ks, heads=heads)
    for name, a, t, p, b in zip("qkv", auto, twin, pallas, banded):
        np.testing.assert_allclose(t.numpy(), p, atol=ATOL, err_msg=f"twin d{name}")
        np.testing.assert_allclose(t.numpy(), b, atol=ATOL, err_msg=f"twin d{name}")
        np.testing.assert_allclose(a.numpy(), p, atol=ATOL, err_msg=f"autograd d{name}")


def _query_range(j: int, n: int, ks: int) -> tuple:
    """The queries along an axis of length ``n`` whose clamped window holds
    key position ``j``, as K2 computes them (``q_lo``/``q_hi`` in
    csrc/na2d_mma.cuh, mirrored by the wrapper): the inclusive range
    (lo, hi)."""
    return kna.q_lo(j, ks), kna.q_hi(j, n, ks)


@pytest.mark.parametrize("n,ks", [(n, ks) for n in (1, 4, 7, 10, 17, 32)
                                  for ks in (1, 3, 5, 7) if ks <= n])
def test_query_range_is_the_inverse_neighbourhood(n, ks):
    starts = [min(max(i - ks // 2, 0), n - ks) for i in range(n)]
    for j in range(n):
        seen = [i for i in range(n) if starts[i] <= j < starts[i] + ks]
        assert _query_range(j, n, ks) == (seen[0], seen[-1])
    assert _query_range(6, 32, 7) == (0, 9)   # 10 rows see key row 6


@pytest.mark.parametrize("bf16", [False, True])
def test_key_plan_covers_every_pair_up_to_40(bf16):
    """For every H, W in 1..40 and ks in 1..7 (dh 128, the most shared
    memory): K2's second-pass plan fits 227 KB; on each axis, by brute
    force, every (key, query) pair of the window relation lies in the
    query union of the key's 4-key patch, that union lies in the key
    tile's query halo, and the halo and the union fit the plan's sizes
    (``span_h`` × ``span_w`` pixels, ``table`` entries a warp)."""
    def axis(n, ks, tile):
        starts = [min(max(i - ks // 2, 0), n - ks) for i in range(n)]
        span = longest = 0
        for t0 in range(0, n, tile):
            h0, h1 = _query_range(t0, n, ks)[0], _query_range(min(t0 + tile, n) - 1, n, ks)[1]
            span = max(span, h1 - h0 + 1)
            for p0 in range(t0, min(t0 + tile, n), 4):
                u0 = _query_range(p0, n, ks)[0]
                u1 = _query_range(min(p0 + 3, n - 1), n, ks)[1]
                longest = max(longest, u1 - u0 + 1)
                assert h0 <= u0 and u1 <= h1
                for j in range(p0, min(p0 + 4, n)):
                    seen = [i for i in range(n) if starts[i] <= j < starts[i] + ks]
                    assert u0 <= seen[0] and seen[-1] <= u1
        return span, longest

    memo = {}
    for H in range(1, 41):
        for W in range(1, 41):
            for ks in range(1, min(7, H, W) + 1):
                p = kna.plan_keys(H, W, 128, ks, bf16)
                assert p.smem <= 227 * 1024
                assert p.chunk == kna.query_chunk(128) and p.table % p.chunk == 0
                (sh, lh), (sw, lw) = (memo.setdefault((n, ks, t), axis(n, ks, t))
                                      for n, t in ((H, p.tile_h), (W, p.tile_w)))
                assert sh <= p.span_h and sw <= p.span_w
                assert lh * lw <= p.table


def _emulate_k2(q, k, v, o, g, ks, heads):
    """K2's two passes as the kernels run them, in float64 numpy. Pass 1 per
    4×4 query patch over the union of its windows: S with the window mask,
    the exact softmax, the log-sum-exp, δ = g·o, dP, dS and dq. Pass 2 per
    4×4 key patch over the union of its keys' query ranges
    (``_query_range``), in chunks of ``query_chunk(dh)`` queries, each
    (key, query) pair masked to the window relation."""
    B, H, W, C = q.shape
    dh = C // heads
    scale = dh ** -0.5
    ks = min(ks, H, W)
    sh = lambda x: x.reshape(B, H, W, heads, dh).astype(np.float64)  # noqa: E731
    q, k, v, o, g = map(sh, (q, k, v, o, g))
    ws = kna.window_start
    rs = np.array([ws(i, H, ks) for i in range(H)])
    cs = np.array([ws(i, W, ks) for i in range(W)])
    dq, dk, dv = (np.zeros_like(q) for _ in range(3))
    lse = np.zeros((B, H, W, heads))
    delta = (g * o).sum(-1)

    def patch(r0, c0, H, W):
        rr, cc = np.meshgrid(np.arange(r0, min(r0 + 4, H)), np.arange(c0, min(c0 + 4, W)),
                             indexing="ij")
        return rr.ravel(), cc.ravel()

    def in_window(qr, qc, kr, kc):      # (queries, keys): key inside the query's window
        return (((kr[None] >= rs[qr][:, None]) & (kr[None] < rs[qr][:, None] + ks))
                & ((kc[None] >= cs[qc][:, None]) & (kc[None] < cs[qc][:, None] + ks)))

    for r0 in range(0, H, 4):
        for c0 in range(0, W, 4):
            qr, qc = patch(r0, c0, H, W)
            kr, kc = np.meshgrid(np.arange(rs[r0], rs[qr.max()] + ks),
                                 np.arange(cs[c0], cs[qc.max()] + ks), indexing="ij")
            kr, kc = kr.ravel(), kc.ravel()
            assert len(kr) <= kna.key_table(ks, False)
            mask = in_window(qr, qc, kr, kc)[None, :, None, :]
            K, V = k[:, kr, kc], v[:, kr, kc]                   # (B, keys, heads, dh)
            s = np.where(mask, np.einsum("bqhd,bkhd->bqhk", q[:, qr, qc], K) * scale, -np.inf)
            m = s.max(-1, keepdims=True)
            l = np.exp(s - m).sum(-1, keepdims=True)
            lse[:, qr, qc] = (m + np.log(l))[..., 0]
            p = np.exp(s - m) / l
            dp = np.einsum("bqhd,bkhd->bqhk", g[:, qr, qc], V)
            ds = p * (dp - delta[:, qr, qc][..., None])
            dq[:, qr, qc] = scale * np.einsum("bqhk,bkhd->bqhd", ds, K)

    chunk = kna.query_chunk(dh)
    for r0 in range(0, H, 4):
        for c0 in range(0, W, 4):
            kr, kc = patch(r0, c0, H, W)
            (lo_r, _), (_, hi_r) = _query_range(r0, H, ks), _query_range(kr.max(), H, ks)
            (lo_c, _), (_, hi_c) = _query_range(c0, W, ks), _query_range(kc.max(), W, ks)
            qr, qc = np.meshgrid(np.arange(lo_r, hi_r + 1), np.arange(lo_c, hi_c + 1),
                                 indexing="ij")
            qr, qc = qr.ravel(), qc.ravel()
            for c in range(0, len(qr), chunk):
                cr, cc = qr[c:c + chunk], qc[c:c + chunk]
                mask = in_window(cr, cc, kr, kc).T[None, :, None, :]     # (1, keys, 1, queries)
                Q, G = q[:, cr, cc], g[:, cr, cc]
                st = np.einsum("bkhd,bqhd->bkhq", k[:, kr, kc], Q) * scale
                pt = np.where(mask, np.exp(st - lse[:, cr, cc].transpose(0, 2, 1)[:, None]), 0.0)
                dpt = np.einsum("bkhd,bqhd->bkhq", v[:, kr, kc], G)
                dst = pt * (dpt - delta[:, cr, cc].transpose(0, 2, 1)[:, None])
                dk[:, kr, kc] += scale * np.einsum("bkhq,bqhd->bkhd", dst, Q)
                dv[:, kr, kc] += np.einsum("bkhq,bqhd->bkhd", pt, G)
    return [x.reshape(B, H, W, C) for x in (dq, dk, dv)]


@pytest.mark.parametrize("shape", [(1, 9, 11, 16, 7, 2), (1, 5, 6, 8, 7, 1),
                                   (1, 8, 8, 8, 3, 1), (1, 10, 7, 8, 5, 1),
                                   (1, 7, 7, 8, 7, 1), (1, 4, 12, 8, 3, 1),
                                   (1, 13, 6, 16, 5, 2), (1, 12, 9, 8, 7, 1)])
def test_k2_algorithm_matches_jax_grad(shape):
    ks, heads = shape[4:]
    q, k, v, g = _inputs(shape, 1)
    o = np.asarray(na2d_pallas(*map(jnp.asarray, (q, k, v)), ks, heads, None))
    ref = _jax_grads(lambda a, b, c: na2d_pallas(a, b, c, ks, heads, None),
                     q, k, v, g, ks, heads)
    for name, ours, r in zip("qkv", _emulate_k2(q, k, v, o, g, ks, heads), ref):
        np.testing.assert_allclose(ours, r, atol=ATOL, err_msg=f"d{name}")


def test_function_with_plain_launchers_gives_autograds_grads(monkeypatch):
    """``NA2DFunction`` with K1 and K2 swapped for their plain twins (K1's
    stand-in returns a tensor with no graph, as the kernel does): its
    gradients are torch autograd's of ``na2d_banded``."""
    def plain_fwd(q, k, v, kernel_size, heads, scale):
        return tna.na2d_banded(q, k, v, kernel_size=kernel_size, heads=heads,
                               scale=scale).detach()

    monkeypatch.setattr(tna, "na2d_fwd", plain_fwd)
    monkeypatch.setattr(tna, "na2d_bwd", tna.na2d_bwd_banded)
    q, k, v, g = map(torch.from_numpy, _inputs((2, 12, 10, 32, 7, 4), 2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tna.NA2DFunction.apply(*leaves, 7, 4, None)
    ours = torch.autograd.grad(out, leaves, g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(tna.na2d_banded(*leaves, kernel_size=7, heads=4),
                              leaves, g)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)


def test_na2d_off_the_cpu_keeps_its_gradient(monkeypatch):
    """A tensor that is not on the CPU (here on the meta device, standing in
    for the card) takes the kernel path. K1 returns a fresh tensor with no
    graph; ``na2d`` must still return one with a ``grad_fn`` whose backward
    launches K2, or training would silently drop the attention branch's
    gradient."""
    calls = []

    def fake_fwd(q, k, v, kernel_size, heads, scale=None):
        calls.append("K1")
        return torch.empty_like(q)

    def fake_bwd(q, k, v, o, g, kernel_size, heads, scale=None):
        calls.append("K2")
        assert o.shape == q.shape and g.is_contiguous()
        return tuple(torch.empty_like(q) for _ in range(3))

    monkeypatch.setattr(tna, "na2d_fwd", fake_fwd)
    monkeypatch.setattr(tna, "na2d_bwd", fake_bwd, raising=False)
    q, k, v = (torch.empty(1, 8, 8, 16, device="meta", requires_grad=True)
               for _ in range(3))
    out = tna.na2d(q, k, v, kernel_size=7, heads=2)
    assert out.grad_fn is not None
    out.sum().backward()
    assert calls == ["K1", "K2"]
    assert q.grad is not None and k.grad is not None and v.grad is not None


class _CudaStub:
    """Just enough of a CUDA tensor for the wrapper's checks; it owns no
    memory, so nothing may ever launch on it."""

    def __init__(self, shape, dtype=torch.float32, contiguous=True, ptr=0):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self._contiguous = contiguous
        self._ptr = ptr

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return self._ptr


def test_backward_wrapper_with_unbuilt_kernel_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    kernel = kna.NA2DBackward(build_dir=str(tmp_path / "build"))
    args = [_CudaStub((1, 8, 8, 16)) for _ in range(5)]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel(*args, kernel_size=7, heads=2)
    assert kernel.launches == 0


@pytest.mark.parametrize("bad,err", [
    (lambda s: s[:3] + [torch.zeros(1, 8, 8, 16), s[4]], ValueError),        # o on CPU
    (lambda s: s[:4] + [_CudaStub((1, 8, 8, 16), contiguous=False)], ValueError),
    (lambda s: s[:4] + [_CudaStub((1, 8, 8, 16), torch.bfloat16)], TypeError),
    (lambda s: s[:3] + [_CudaStub((1, 8, 4, 16)), s[4]], ValueError),
    (lambda s: [_CudaStub((1, 8, 8, 24))] * 5, ValueError),                  # dh = 12
    (lambda s: s[:2] + [_CudaStub((1, 8, 8, 16), ptr=8)] + s[3:], ValueError),  # misaligned
])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(bad, err, tmp_path):
    kernel = kna.NA2DBackward(build_dir=str(tmp_path))
    with pytest.raises(err):
        kernel(*bad([_CudaStub((1, 8, 8, 16)) for _ in range(5)]),
               kernel_size=7, heads=2)
    assert kernel.launches == 0
