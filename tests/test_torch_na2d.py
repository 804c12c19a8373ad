"""The port's neighborhood attention (flocoder_torch.ops) against the JAX
package's: its plain version against ``na2d_reference``, ``na2d_banded`` and
the Pallas kernel in interpret mode, at the shapes of
tests/test_pallas_na2d.py plus one with head dim 16. Also the CUDA kernel
K1's Python side: its tile choice, its input checks, and that a CUDA tensor
never falls back to the plain version. The kernel itself runs only on the
card: tests/test_torch_kernels_gpu.py.

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
    """The tile fits the block limits, and the kernel's halo (same
    formulas as csrc/na2d_fwd.cu) holds every query's clamped window."""
    th, tw = kna.pick_tile(H, W, dh, ks)
    assert th * tw <= 64
    assert kna.smem_bytes(th, tw, H, W, dh, ks) <= 227 * 1024
    kh, kw = min(th + ks - 1, H), min(tw + ks - 1, W)
    for r0 in range(0, H, th):
        hr0 = min(max(r0 - ks // 2, 0), H - kh)
        for qr in range(r0, min(r0 + th, H)):
            rs = min(max(qr - ks // 2, 0), H - ks)
            assert hr0 <= rs and rs + ks <= hr0 + kh
    for c0 in range(0, W, tw):
        hc0 = min(max(c0 - ks // 2, 0), W - kw)
        for qc in range(c0, min(c0 + tw, W)):
            cs = min(max(qc - ks // 2, 0), W - ks)
            assert hc0 <= cs and cs + ks <= hc0 + kw


class _CudaStub:
    """Just enough of a CUDA tensor for the wrapper's checks; it owns no
    memory, so nothing may ever launch on it."""

    def __init__(self, shape, dtype=torch.float32, contiguous=True):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self._contiguous = contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._contiguous


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
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, err, tmp_path):
    kernel = kna.NA2DForward(build_dir=str(tmp_path))
    with pytest.raises(err):
        kernel(*bad(), kernel_size=7, heads=2)
    assert kernel.launches == 0
