// 2-D neighborhood attention forward (NATTEN clamped windows) for Hopper.
//
// Replaces the Pallas TPU kernel flocoder_tpu/ops/pallas/na2d.py:_na2d_kernel
// (entry na2d_pallas -> _na2d_fwd_impl). Same function: q, k, v are NHWC
// (B, H, W, C) with C = heads * dh; every query attends to exactly ks x ks
// keys (ks = min(kernel_size, H, W)), windows slide inward at the borders;
// logits are (q * scale) . k, the softmax is taken in fp32.
//
// What bounds it on an H100: per (pixel, head) it does 49 * dh * 4 FLOPs
// (ks = 7) against 4 * dh * sizeof(T) bytes of q/k/v/out, about 12 FLOP/byte
// in fp32 -- under the card's 67 TFLOP/s / 3.35 TB/s = 20 FLOP/byte, so it
// is about memory-bound in fp32 and more so in bf16. The design therefore
// reads q, k, v from device memory as few times as it can and keeps the
// window math on the CUDA cores, instead of the TPU kernel's dense masked
// band matmul (which spends (tile_h+ks-1)*W / ks^2 of its MXU work on
// masked keys):
//
// - One block per (batch*head, 2-D query tile of tile_h x tile_w). The tile's
//   K/V halo, (tile_h+ks-1) x (tile_w+ks-1) pixels clamped into the map,
//   is staged once in shared memory as fp32, so each K/V element is read
//   from device memory about halo/tile times (3x at 8x8 tiles, k=7) instead
//   of ks^2 = 49 times. The host picks the tile so that two blocks fit on
//   an SM (flocoder_torch/ops/kernels/na2d.py:pick_tile).
// - A team of 8 threads owns one query: lane t holds channels t, t+8, ...
//   (dh/8 of them) of q and of the output accumulator in registers. Each of
//   the ks^2 keys costs dh/8 FMAs per lane plus a 3-step xor-shuffle sum.
// - Online softmax in fp32 (running max and sum), so the probabilities are
//   never stored; the output is divided by the sum once at the end.
// - Shared-memory rows are padded by 8 floats (stride dh+8) so that the four
//   teams of a warp, which read neighbouring keys, hit disjoint banks.
//
// Plain C interface (bound with ctypes); the wrapper validates shapes and
// dtypes, allocates the output, and raises if the return code is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTeam = 8;        // threads per query
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// CPT = channels per thread = dh / kTeam.
template <typename T, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
na2d_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out, int H, int W,
                int heads, int ks, int tile_h, int tile_w, int halo_h,
                int halo_w, int tiles_w, int n_tiles, float scale) {
  extern __shared__ float smem[];
  constexpr int dh = CPT * kTeam;
  constexpr int stride = dh + kTeam;
  const int C = heads * dh;
  float* sk = smem;
  float* sv = smem + halo_h * halo_w * stride;

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int r0 = (tile / tiles_w) * tile_h;
  const int c0 = (tile - (tile / tiles_w) * tiles_w) * tile_w;
  // Halo origin: the band start of the Pallas kernel, in both directions.
  const int hr0 = min(max(r0 - ks / 2, 0), H - halo_h);
  const int hc0 = min(max(c0 - ks / 2, 0), W - halo_w);

  const size_t img = (size_t)b * H * W;
  const int n_halo = halo_h * halo_w * dh;
  for (int i = threadIdx.x; i < n_halo; i += blockDim.x) {
    const int key = i / dh;
    const int ch = i - key * dh;
    const int kr = key / halo_w;
    const int kc = key - kr * halo_w;
    const size_t g = (img + (size_t)(hr0 + kr) * W + (hc0 + kc)) * C + hd * dh + ch;
    sk[key * stride + ch] = to_f32(k[g]);
    sv[key * stride + ch] = to_f32(v[g]);
  }
  __syncthreads();

  // Every team runs the same ks*ks loop so the shuffles stay warp-uniform.
  // Teams past the tile (block padded to whole warps) redo query (r0, c0);
  // teams past the map's ragged edge redo the last row/column, which lies
  // in this tile and so in its halo. Neither stores.
  const int team = threadIdx.x / kTeam;
  const int lane = threadIdx.x - team * kTeam;
  const bool in_tile = team < tile_h * tile_w;
  const int qr_raw = in_tile ? r0 + team / tile_w : r0;
  const int qc_raw = in_tile ? c0 + team % tile_w : c0;
  const bool live = in_tile && qr_raw < H && qc_raw < W;
  const int qr = min(qr_raw, H - 1);
  const int qc = min(qc_raw, W - 1);
  const size_t qoff = (img + (size_t)qr * W + qc) * C + hd * dh + lane;

  float qv[CPT];
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    qv[j] = to_f32(q[qoff + kTeam * j]) * scale;
    acc[j] = 0.f;
  }

  const int rs = min(max(qr - ks / 2, 0), H - ks) - hr0;
  const int cs = min(max(qc - ks / 2, 0), W - ks) - hc0;
  float m = -INFINITY;
  float l = 0.f;
  for (int i = 0; i < ks; ++i) {
    const float* krow = sk + ((rs + i) * halo_w + cs) * stride + lane;
    const float* vrow = sv + ((rs + i) * halo_w + cs) * stride + lane;
    for (int jj = 0; jj < ks; ++jj) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) s = fmaf(qv[j], krow[jj * stride + kTeam * j], s);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = fmaf(l, corr, p);
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] = fmaf(p, vrow[jj * stride + kTeam * j], acc[j] * corr);
      m = m_new;
    }
  }
  if (live) {
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < CPT; ++j) out[qoff + kTeam * j] = from_f32<T>(acc[j] * inv);
  }
}

template <typename T, int CPT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int W, int heads, int ks, int tile_h,
                   int tile_w, float scale, cudaStream_t stream) {
  const int halo_h = min(tile_h + ks - 1, H);
  const int halo_w = min(tile_w + ks - 1, W);
  const int tiles_h = (H + tile_h - 1) / tile_h;
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int n_tiles = tiles_h * tiles_w;
  const size_t smem = 2u * halo_h * halo_w * (CPT * kTeam + kTeam) * sizeof(float);
  const int threads = ((tile_h * tile_w * kTeam + 31) / 32) * 32;
  const long long blocks = (long long)B * heads * n_tiles;
  if (threads > kMaxThreads || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(na2d_fwd_kernel<T, CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  na2d_fwd_kernel<T, CPT><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, W, heads, ks, tile_h, tile_w, halo_h, halo_w,
      tiles_w, n_tiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int cpt, const void* q, const void* k, const void* v,
                     void* out, int B, int H, int W, int heads, int ks,
                     int tile_h, int tile_w, float scale, cudaStream_t s) {
#define NA2D_CASE(N) \
  case N:            \
    return launch<T, N>(q, k, v, out, B, H, W, heads, ks, tile_h, tile_w, scale, s);
  switch (cpt) {
    NA2D_CASE(1) NA2D_CASE(2) NA2D_CASE(3) NA2D_CASE(4)
    NA2D_CASE(5) NA2D_CASE(6) NA2D_CASE(7) NA2D_CASE(8)
    NA2D_CASE(9) NA2D_CASE(10) NA2D_CASE(11) NA2D_CASE(12)
    NA2D_CASE(13) NA2D_CASE(14) NA2D_CASE(15) NA2D_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef NA2D_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dh must be a multiple of 8, at most 128.
// Returns a cudaError_t (0 = launched).
extern "C" int na2d_fwd(const void* q, const void* k, const void* v, void* out,
                        int dtype, int B, int H, int W, int heads, int dh,
                        int ks, int tile_h, int tile_w, float scale,
                        void* stream) {
  if (dh % kTeam != 0 || dh < kTeam || dh > 16 * kTeam || ks < 1 || ks > H ||
      ks > W || tile_h < 1 || tile_w < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpt = dh / kTeam;
  if (dtype == 0)
    return (int)dispatch<float>(cpt, q, k, v, out, B, H, W, heads, ks, tile_h, tile_w, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(cpt, q, k, v, out, B, H, W, heads, ks, tile_h, tile_w,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}
