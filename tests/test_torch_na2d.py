"""The port's neighborhood attention (flocoder_torch.ops) against the JAX
package's: its plain version against ``na2d_reference``, ``na2d_banded`` and
the Pallas kernel in interpret mode, at the shapes of
tests/test_pallas_na2d.py plus one with head dim 16. Also the CUDA kernel
K1's Python side: its launch plan against brute force, its input checks,
that a CUDA tensor never falls back to the plain version, the build hash,
and the 3xTF32 arithmetic of its products, emulated. The kernel itself runs
only on the card: tests/test_torch_kernels_gpu.py.

Tolerance: 1e-5 absolute in fp32; the outputs are convex combinations of
unit-normal values, and both sides take the softmax in fp32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flocoder_tpu.ops.neighborhood_attention import na2d_banded as jax_banded
from flocoder_tpu.ops.neighborhood_attention import na2d_reference as jax_reference
from flocoder_tpu.ops.pallas.na2d import na2d_pallas
from flocoder_torch.ops import neighborhood_attention as tna
from flocoder_torch.ops.kernels import na2d as kna


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six xdist workers on a few cores; torch's default of one
    thread per core oversubscribes them, and its OpenMP pool then stalls
    (a 0.5 s test took 30 s). One thread each keeps these tests quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = 1e-5

# (B, H, W, C, kernel_size, heads)
SHAPES = [
    (2, 16, 16, 32, 7, 4),
    (1, 8, 8, 8, 3, 2),
    (1, 16, 12, 8, 5, 1),   # non-square
    (2, 8, 8, 32, 7, 2),    # head dim 16
]


def _qkv(shape, seed):
    B, H, W, C = shape[:4]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, W, C)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_port_na2d_matches_jax_reference_and_banded(shape):
    ks, heads = shape[4:]
    q, k, v = _qkv(shape, 0)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref = np.asarray(jax_reference(jq, jk, jv, kernel_size=ks, heads=heads))
    banded = np.asarray(jax_banded(jq, jk, jv, kernel_size=ks, heads=heads))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ours = tna.na2d(tq, tk, tv, kernel_size=ks, heads=heads).numpy()
    ours_ref = tna.na2d_reference(tq, tk, tv, kernel_size=ks, heads=heads).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL)
    np.testing.assert_allclose(ours, banded, atol=ATOL)
    np.testing.assert_allclose(ours_ref, ref, atol=ATOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_port_na2d_matches_pallas_interpret(shape):
    ks, heads = shape[4:]
    q, k, v = _qkv(shape, 1)
    pallas = np.asarray(na2d_pallas(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), ks, heads, None))
    ours = tna.na2d(*map(torch.from_numpy, (q, k, v)), kernel_size=ks,
                    heads=heads).numpy()
    np.testing.assert_allclose(ours, pallas, atol=ATOL)


@pytest.mark.parametrize("H,W,dh,ks", [
    (32, 32, 64, 7), (16, 16, 128, 7), (16, 16, 16, 7), (24, 40, 8, 7),
    (17, 13, 24, 7), (5, 6, 32, 5), (8, 8, 16, 3), (64, 64, 128, 7),
])
def test_pick_tile_fits_and_covers_every_window(H, W, dh, ks):
    """K1's plan (``plan_queries``) fits the block limits in both dtypes,
    and the halo of each of its tiles (same formulas as csrc/na2d_fwd.cu)
    holds the key union of every 4×4 patch, which holds every query's
    clamped window."""
    for bf16 in (False, True):
        p = kna.plan_queries(H, W, dh, ks, bf16)
        assert p.tile_h % 4 == 0 and p.tile_w % 4 == 0
        assert (p.tile_h // 4) * (p.tile_w // 4) <= 8
        assert p.smem <= 227 * 1024
        assert (p.halo_h, p.halo_w) == (min(p.tile_h + ks - 1, H), min(p.tile_w + ks - 1, W))
        _axis_covered(H, ks, p.tile_h, p.halo_h)
        _axis_covered(W, ks, p.tile_w, p.halo_w)


def _axis_covered(n: int, ks: int, tile: int, halo: int) -> int:
    """On one axis of length ``n``: every query's window lies in its 4-query
    patch's key union (at most 3 + ks long), which lies in its tile's halo
    (origin as in the kernels). Windows and unions are products of their
    row and column intervals, so a 2-D window lies in a 2-D union exactly
    when this holds on both axes. Returns the longest union."""
    ws = [kna.window_start(i, n, ks) for i in range(n)]
    longest = 0
    for t0 in range(0, n, tile):
        h0 = min(max(t0 - ks // 2, 0), n - halo)
        for p0 in range(t0, min(t0 + tile, n), 4):
            u0, u1 = ws[p0], ws[min(p0 + 3, n - 1)] + ks
            longest = max(longest, u1 - u0)
            assert u1 - u0 <= ks + 3
            assert h0 <= u0 and u1 <= h0 + halo
            for i in range(p0, min(p0 + 4, n)):
                assert u0 <= ws[i] and ws[i] + ks <= u1
    return longest


@pytest.mark.parametrize("bf16", [False, True])
def test_query_plan_covers_every_map_up_to_40(bf16):
    """For every H, W in 1..40 and ks in 1..7 (dh 128, the most shared
    memory): the plan of K1 and of K2's first pass fits 227 KB, and its
    tiles' halos hold every patch's key union and every query's window,
    checked by brute force on each axis; the union fits the warp's key
    table."""
    covered = {}
    for H in range(1, 41):
        for W in range(1, 41):
            for ks in range(1, min(7, H, W) + 1):
                p = kna.plan_queries(H, W, 128, ks, bf16)
                assert p.smem <= 227 * 1024
                assert p.table == kna.key_table(ks, bf16)
                ext = []
                for n, tile, halo in ((H, p.tile_h, p.halo_h), (W, p.tile_w, p.halo_w)):
                    if (n, ks, tile) not in covered:
                        covered[n, ks, tile] = _axis_covered(n, ks, tile, halo)
                    ext.append(covered[n, ks, tile])
                assert ext[0] * ext[1] <= p.table


def test_build_hash_covers_the_headers(tmp_path):
    """The library's name changes when its source, or any shared header
    beside it, changes, so an edited header never loads a stale build."""
    from flocoder_torch.ops.kernels.build import library_path
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "m.cuh"\n')
    (src / "m.cuh").write_text("// v1\n")
    paths = [library_path("k.cu", str(tmp_path / "b"), str(src))]
    (src / "m.cuh").write_text("// v2\n")
    paths.append(library_path("k.cu", str(tmp_path / "b"), str(src)))
    (src / "n.cuh").write_text("// new\n")
    paths.append(library_path("k.cu", str(tmp_path / "b"), str(src)))
    (src / "k.cu").write_text('#include "m.cuh"\n// edited\n')
    paths.append(library_path("k.cu", str(tmp_path / "b"), str(src)))
    assert len(set(paths)) == 4
    assert all(p.startswith(str(tmp_path / "b" / "libk_")) for p in paths)
    assert library_path("k.cu", str(tmp_path / "b"), str(src)) == paths[-1]


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the dropped 13 bits to
    the magnitude, then clear them."""
    b = x.astype(np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tc_dot(a: np.ndarray, b: np.ndarray, split: bool) -> np.ndarray:
    """sum(a * b, -1) as the tensor cores take it, in fp32: with ``split``
    the 3xTF32 product of csrc/na2d_mma.cuh (x = hi + lo, hi rounded by
    cvt.rna, lo = x - hi of which the core reads the top 10 mantissa bits;
    lo·hi' + hi·lo' + hi·hi'), else one TF32 product hi·hi'."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    if not split:
        return (ah * bh).sum(-1, dtype=np.float32)
    trunc = lambda x: (x.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)  # noqa: E731
    al, bl = trunc(a - ah), trunc(b - bh)
    return ((al * bh).sum(-1, dtype=np.float32) + (ah * bl).sum(-1, dtype=np.float32)
            + (ah * bh).sum(-1, dtype=np.float32))


@pytest.mark.parametrize("dh", [16, 64, 128])
def test_3xtf32_split_holds_na2d_to_fp32_accuracy(dh):
    """NA2D with both products (S = Q·Kᵀ and O = P·V) taken as K1 takes them
    for fp32 inputs: the 3xTF32 split stays within 1e-5 of fp64; a single
    TF32 product misses the kernel's 1e-4 gate."""
    H = W = 10
    ks = 7
    rng = np.random.default_rng(dh)
    q, k, v = (rng.normal(size=(H, W, dh)).astype(np.float32) for _ in range(3))
    rs = [kna.window_start(i, H, ks) for i in range(H)]
    cs = [kna.window_start(i, W, ks) for i in range(W)]
    kw = np.stack([k[rs[r]:rs[r] + ks, cs[c]:cs[c] + ks].reshape(-1, dh)
                   for r in range(H) for c in range(W)])          # (N, ks², dh)
    vw = np.stack([v[rs[r]:rs[r] + ks, cs[c]:cs[c] + ks].reshape(-1, dh)
                   for r in range(H) for c in range(W)])
    qn = q.reshape(-1, 1, dh)
    scale = dh ** -0.5

    s64 = (qn.astype(np.float64) * kw).sum(-1) * scale
    p64 = np.exp(s64 - s64.max(-1, keepdims=True))
    ref = np.einsum("nj,njd->nd", p64 / p64.sum(-1, keepdims=True), vw.astype(np.float64))
    errs = {}
    for split in (True, False):
        s = _tc_dot(np.broadcast_to(qn, kw.shape), kw, split) * np.float32(scale)
        p = np.exp(s - s.max(-1, keepdims=True))
        o = _tc_dot(np.broadcast_to(p[:, None, :], (p.shape[0], dh, p.shape[1])),
                    vw.transpose(0, 2, 1), split) / p.sum(-1, keepdims=True)
        errs[split] = np.abs(o - ref).max()
    assert errs[True] < 1e-5, errs
    assert errs[False] > 1e-4, errs


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


def test_cuda_tensor_with_unbuilt_kernel_raises(tmp_path, monkeypatch):
    """On a CUDA tensor ``na2d`` goes to K1; with no nvcc to build it, the
    call raises instead of computing the plain version."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    kernel = kna.NA2DForward(build_dir=str(tmp_path / "build"))
    monkeypatch.setattr(tna, "na2d_fwd", kernel)
    q, k, v = (_CudaStub((1, 8, 8, 16)) for _ in range(3))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tna.na2d(q, k, v, kernel_size=7, heads=2)
    assert kernel.launches == 0


@pytest.mark.parametrize("bad,err", [
    (lambda: (torch.zeros(1, 8, 8, 16),) * 3, ValueError),          # on CPU
    (lambda: (_CudaStub((1, 8, 8, 24)),) * 3, ValueError),          # dh = 12
    (lambda: (_CudaStub((1, 8, 8, 16), torch.float16),) * 3, TypeError),
    (lambda: (_CudaStub((1, 8, 8, 16)), _CudaStub((1, 8, 8, 16)),
              _CudaStub((1, 8, 8, 16), contiguous=False)), ValueError),
    (lambda: (_CudaStub((1, 8, 8, 16)), _CudaStub((1, 8, 4, 16)),
              _CudaStub((1, 8, 8, 16))), ValueError),
    (lambda: (_CudaStub((1, 8, 8, 16)), _CudaStub((1, 8, 8, 16), torch.bfloat16),
              _CudaStub((1, 8, 8, 16))), TypeError),
    (lambda: (_CudaStub((1, 8, 8, 16)), _CudaStub((1, 8, 8, 16), ptr=4),
              _CudaStub((1, 8, 8, 16))), ValueError),                     # misaligned
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, err, tmp_path):
    kernel = kna.NA2DForward(build_dir=str(tmp_path))
    with pytest.raises(err):
        kernel(*bad(), kernel_size=7, heads=2)
    assert kernel.launches == 0
