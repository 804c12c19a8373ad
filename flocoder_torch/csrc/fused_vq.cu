// The codec's compression tail fused with the residual-VQ (RVQ) search, for
// Hopper. One source, three kernels:
//
// - K4, fused_compress_vq: z.W + b over N tokens, then L greedy RVQ levels.
//   Replaces the Pallas TPU kernel flocoder_tpu/ops/pallas/fused_vq.py:_kernel
//   (entry fused_compress_vq).
// - K3, fused_compress_tail_vq: per image, 1x1 conv Din->D + bias ->
//   GroupNorm (biased variance) -> SiLU -> 3x3 conv, padding 1, + bias -> the
//   RVQ search of K4. Replaces fused_vq.py:_tail_kernel (entry
//   fused_compress_tail_vq); the codec's pre-encode path runs it once per
//   batch.
// - K5, compress_tail_debug: K3's tail without the search, writing the
//   intermediates y1 (after the 1x1), y2 (after GroupNorm + SiLU) and out
//   (after the 3x3). Replaces benchmarks/fused_probe.py:dbg_kernel.
//
// K3 and K5 are one templated kernel (tail_kernel<D, kSearch>); all three
// share one RVQ search (rvq_search). Every value is fp32 end to end, and the
// distances are ||r||^2 + ||c||^2 - 2 r.c with the first minimum on ties, as
// in the TPU kernels, so the picks agree with an fp64 oracle up to ties
// inside fp32 rounding.
//
// What bounds them on an H100: at the pre-encode shape (B=32, 16x16, Din=128,
// D=4, L=4, K=96) K3 reads 4.2 MB of activations and writes 0.25 MB, about
// 1.3 us at 3.35 TB/s, and does ~40 MFLOP of search and ~35 MFLOP of
// projection, far under either peak: a launch of this size is bound by
// launch latency and by the per-image serial work, not by bytes. The design
// keeps everything after the read of h on chip:
//
// - K3/K5: one block per image, because the GroupNorm statistics are per
//   image. The 1x1 projection of every token goes into shared memory laid
//   out channel-major, y[D][H*W], so that neighbouring threads (tokens) hit
//   neighbouring banks in every later step. h is read through its strides:
//   NCHW memory (what the codec's convolutions leave) is coalesced along
//   tokens; NHWC memory is read correctly but strided. GroupNorm takes two
//   passes over shared memory (the mean, then the mean of squared
//   deviations), which is more accurate than the TPU kernel's one-pass
//   E[y^2] - m^2. SiLU is applied in place, then the 3x3 convolution reads
//   the zero-padded neighbourhood from shared memory with its 9*D*D weights
//   there too, and each thread runs the search on its token's D values in
//   registers. Maps larger than the block loop over tokens. With B=32 images
//   only 32 of 132 SMs work: a cluster per image with the statistics in
//   distributed shared memory is the first lever for a later change.
// - K4: a block per tile of 128 tokens. The TPU kernel's (tile, Din) block
//   would make one thread per token read its own Din-float row, strided by
//   Din across a warp; here a warp projects one token at a time with its
//   lanes along Din (coalesced), reduces the D sums with shuffles and
//   leaves them in shared memory, and then one thread per token runs the
//   search.
// - The codebooks and their squared norms sit in shared memory (6 KB at
//   L=4, K=96, D=4; 24 KB at 3x512x4); every thread of a warp reads the same
//   code at once, a broadcast.
//
// Plain C interface (bound with ctypes). The wrappers in
// flocoder_torch/ops/kernels/fused_vq.py validate dtypes, shapes, D, groups,
// layouts and devices, allocate the outputs and raise if the return code is
// not 0. The launch layout (block sizes, shared memory) is worked out here
// alone: an entry whose block would need more shared memory than a Hopper
// block may have returns kErrSharedMemory, which the wrappers raise as a
// ValueError. Only the D values of the repo's configs are instantiated
// (FUSED_VQ_CASES); any other D returns cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileTokens = 128;       // K4: tokens, and threads, per block
constexpr int kMaxTailThreads = 256;   // K3/K5: threads per block at most
constexpr int kMaxWarps = kMaxTailThreads / 32;
constexpr size_t kMaxSmem = 232448;    // 227 KB, the most a block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr int kErrSharedMemory = -1;   // outside cudaError_t's range

// The codebooks (L*K codes of D floats) and each code's squared norm, into
// shared memory. Ends with the block synchronised.
template <int D>
__device__ __forceinline__ void stage_codebooks(const float* __restrict__ cb, int n_codes,
                                                float* s_cb, float* s_c2) {
  for (int i = threadIdx.x; i < n_codes * D; i += blockDim.x) s_cb[i] = cb[i];
  __syncthreads();
  for (int j = threadIdx.x; j < n_codes; j += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(s_cb[j * D + d], s_cb[j * D + d], s);
    s_c2[j] = s;
  }
  __syncthreads();
}

// Greedy RVQ of one token's D values r: at each level the code with the least
// (||r||^2 + ||c||^2) - 2 r.c, the first one on ties, is subtracted from the
// residual. Writes z_q (the exact sum of the picked codes) and the L indices.
template <int D>
__device__ __forceinline__ void rvq_search(float (&r)[D], const float* s_cb, const float* s_c2,
                                           int L, int K, float* __restrict__ zq,
                                           int* __restrict__ idx) {
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  for (int l = 0; l < L; ++l) {
    const float* c = s_cb + (size_t)l * K * D;
    const float* c2 = s_c2 + (size_t)l * K;
    float r2 = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) r2 = fmaf(r[d], r[d], r2);
    float best = INFINITY;
    int bi = 0;
    for (int k = 0; k < K; ++k) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(r[d], c[k * D + d], dot);
      const float dist = (r2 + c2[k]) - 2.f * dot;
      if (dist < best) {
        best = dist;
        bi = k;
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float q = c[bi * D + d];
      acc[d] += q;
      r[d] -= q;
    }
    idx[l] = bi;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) zq[d] = acc[d];
}

// K4. Block: kTileTokens threads and tokens. Shared memory: w transposed to
// [D][Din], the projected tile [D][kTileTokens], the squared norms [L*K] and
// the codebooks [L*K][D].
template <int D>
__global__ void __launch_bounds__(kTileTokens)
compress_vq_kernel(const float* __restrict__ z, const float* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ cb,
                   float* __restrict__ zq, int* __restrict__ idx, long long N, int Din,
                   int L, int K) {
  extern __shared__ float smem[];
  float* s_w = smem;
  float* s_x = s_w + (size_t)D * Din;
  float* s_c2 = s_x + D * kTileTokens;
  float* s_cb = s_c2 + (size_t)L * K;
  for (int i = threadIdx.x; i < Din * D; i += blockDim.x) {
    const int c = i / D;
    s_w[(i - c * D) * Din + c] = w[i];
  }
  stage_codebooks<D>(cb, L * K, s_cb, s_c2);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long tile0 = (long long)blockIdx.x * kTileTokens;
  for (int t = warp; t < kTileTokens; t += n_warps) {
    const long long tok = tile0 + t;
    if (tok >= N) break;  // the same for every lane of the warp
    const float* row = z + tok * Din;
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    for (int c = lane; c < Din; c += 32) {
      const float v = row[c];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(v, s_w[d * Din + c], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[d] += __shfl_xor_sync(kFull, acc[d], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) s_x[d * kTileTokens + t] = acc[d] + b[d];
    }
  }
  __syncthreads();

  const long long tok = tile0 + threadIdx.x;
  if (tok < N) {
    float r[D];
#pragma unroll
    for (int d = 0; d < D; ++d) r[d] = s_x[d * kTileTokens + threadIdx.x];
    rvq_search<D>(r, s_cb, s_c2, L, K, zq + tok * D, idx + tok * L);
  }
}

// Sums v[0..D) over the block; every thread gets the totals. All threads of
// the block must call it; blockDim.x is a multiple of 32, at most
// kMaxTailThreads.
template <int D>
__device__ __forceinline__ void block_sum(float (&v)[D], float* s_red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[d] += __shfl_xor_sync(kFull, v[d], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) s_red[warp * D + d] = v[d];
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float s = 0.f;
    for (int i = 0; i < n_warps; ++i) s += s_red[i * D + d];
    v[d] = s;
  }
  __syncthreads();  // s_red is reused by the next call
}

// Per channel d, the sum of tot[] over the channels of d's group (groups of
// gsz consecutive channels), with static register indices only.
template <int D>
__device__ __forceinline__ void group_totals(const float (&tot)[D], int gsz, float (&out)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < D; ++e)
      if (e / gsz == d / gsz) s += tot[e];
    out[d] = s;
  }
}

// K3 (kSearch) and K5 (!kSearch): one block per image. h is read as
// h[img*sb + c*sc + p*sp] with p = y*W + x. w1 is the 1x1 conv's (D, Din)
// weight, cw the 3x3 conv's OIHW (D, D, 3, 3) weight. Shared memory: the map
// [D][H*W], w1 [D][Din], cw [D*D*9], the reduction scratch [kMaxWarps][D],
// then (K3 only) the squared norms [L*K] and the codebooks [L*K][D].
template <int D, bool kSearch>
__global__ void __launch_bounds__(kMaxTailThreads)
tail_kernel(const float* __restrict__ h, long long sb, long long sc, long long sp, int H, int W,
            int Din, const float* __restrict__ w1, const float* __restrict__ b1,
            const float* __restrict__ gs, const float* __restrict__ gb,
            const float* __restrict__ cw, const float* __restrict__ cbias,
            const float* __restrict__ cb, int L, int K, int groups, float eps,
            float* __restrict__ zq, int* __restrict__ idx, float* __restrict__ y1_out,
            float* __restrict__ y2_out, float* __restrict__ conv_out) {
  extern __shared__ float smem[];
  const int HW = H * W;
  float* s_y = smem;
  float* s_w1 = s_y + (size_t)D * HW;
  float* s_cw = s_w1 + (size_t)D * Din;
  float* s_red = s_cw + 9 * D * D;
  float* s_c2 = s_red + kMaxWarps * D;
  float* s_cb = s_c2 + (size_t)L * K;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long img = blockIdx.x;

  for (int i = tid; i < D * Din; i += nt) s_w1[i] = w1[i];
  for (int i = tid; i < 9 * D * D; i += nt) s_cw[i] = cw[i];
  if (kSearch) stage_codebooks<D>(cb, L * K, s_cb, s_c2);
  __syncthreads();

  // 1x1 projection of this thread's tokens
  const float* himg = h + img * sb;
  for (int p = tid; p < HW; p += nt) {
    float acc[D];
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    const float* hp = himg + (long long)p * sp;
#pragma unroll 8
    for (int c = 0; c < Din; ++c) {
      const float v = hp[(long long)c * sc];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(v, s_w1[d * Din + c], acc[d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float y = acc[d] + b1[d];
      s_y[d * HW + p] = y;
      if (!kSearch) y1_out[(img * HW + p) * D + d] = y;
    }
  }

  // GroupNorm statistics, two passes over this thread's tokens
  const int gsz = D / groups;
  const float inv_n = 1.f / (float)(HW * gsz);
  float part[D], mean[D], rstd[D];
#pragma unroll
  for (int d = 0; d < D; ++d) part[d] = 0.f;
  for (int p = tid; p < HW; p += nt) {
#pragma unroll
    for (int d = 0; d < D; ++d) part[d] += s_y[d * HW + p];
  }
  block_sum<D>(part, s_red);
  group_totals<D>(part, gsz, mean);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    mean[d] *= inv_n;
    part[d] = 0.f;
  }
  for (int p = tid; p < HW; p += nt) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float t = s_y[d * HW + p] - mean[d];
      part[d] = fmaf(t, t, part[d]);
    }
  }
  block_sum<D>(part, s_red);
  group_totals<D>(part, gsz, rstd);
#pragma unroll
  for (int d = 0; d < D; ++d) rstd[d] = 1.f / sqrtf(rstd[d] * inv_n + eps);

  // normalise, scale and shift, SiLU, in place
  for (int p = tid; p < HW; p += nt) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float y = (s_y[d * HW + p] - mean[d]) * rstd[d] * gs[d] + gb[d];
      y = y / (1.f + expf(-y));
      s_y[d * HW + p] = y;
      if (!kSearch) y2_out[(img * HW + p) * D + d] = y;
    }
  }
  __syncthreads();

  // 3x3 convolution, zero outside the map, then the search
  for (int p = tid; p < HW; p += nt) {
    const int py = p / W;
    const int px = p - py * W;
    float acc[D];
#pragma unroll
    for (int o = 0; o < D; ++o) acc[o] = cbias[o];
    for (int ky = 0; ky < 3; ++ky) {
      const int yy = py + ky - 1;
      if (yy < 0 || yy >= H) continue;
      for (int kx = 0; kx < 3; ++kx) {
        const int xx = px + kx - 1;
        if (xx < 0 || xx >= W) continue;
        const int q = yy * W + xx;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float v = s_y[i * HW + q];
#pragma unroll
          for (int o = 0; o < D; ++o)
            acc[o] = fmaf(v, s_cw[((o * D + i) * 3 + ky) * 3 + kx], acc[o]);
        }
      }
    }
    const long long tok = img * HW + p;
    if (kSearch) {
      rvq_search<D>(acc, s_cb, s_c2, L, K, zq + tok * D, idx + tok * L);
    } else {
#pragma unroll
      for (int o = 0; o < D; ++o) conv_out[tok * D + o] = acc[o];
    }
  }
}

size_t compress_vq_smem(int D, int Din, int L, int K) {
  return sizeof(float) * ((size_t)D * Din + (size_t)D * kTileTokens + (size_t)L * K * (D + 1));
}

size_t tail_smem(int D, int HW, int Din, int L, int K) {
  return sizeof(float) * ((size_t)D * HW + (size_t)D * Din + 9 * D * D + kMaxWarps * D +
                          (size_t)L * K * (D + 1));
}

// 0, kErrSharedMemory, or the cudaError_t of raising the kernel's limit.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return kErrSharedMemory;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_compress_vq(const float* z, const float* w, const float* b, const float* cb, float* zq,
                       int* idx, long long N, int Din, int L, int K, cudaStream_t s) {
  const size_t smem = compress_vq_smem(D, Din, L, K);
  const int err = allow_smem(compress_vq_kernel<D>, smem);
  if (err != 0) return err;
  const long long blocks = (N + kTileTokens - 1) / kTileTokens;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  compress_vq_kernel<D><<<(unsigned)blocks, kTileTokens, smem, s>>>(z, w, b, cb, zq, idx, N, Din,
                                                                    L, K);
  return (int)cudaGetLastError();
}

template <int D, bool kSearch>
int launch_tail(const float* h, long long sb, long long sc, long long sp, int B, int H, int W,
                int Din, const float* w1, const float* b1, const float* gs, const float* gb,
                const float* cw, const float* cbias, const float* cb, int L, int K, int groups,
                float eps, float* zq, int* idx, float* y1, float* y2, float* out,
                cudaStream_t s) {
  const int HW = H * W;
  const size_t smem = tail_smem(D, HW, Din, kSearch ? L : 0, kSearch ? K : 0);
  const int err = allow_smem(tail_kernel<D, kSearch>, smem);
  if (err != 0) return err;
  const int threads = HW >= kMaxTailThreads ? kMaxTailThreads : ((HW + 31) / 32) * 32;
  tail_kernel<D, kSearch><<<B, threads, smem, s>>>(h, sb, sc, sp, H, W, Din, w1, b1, gs, gb, cw,
                                                   cbias, cb, L, K, groups, eps, zq, idx, y1, y2,
                                                   out);
  return (int)cudaGetLastError();
}

// The latent widths of the repo's configs: 3 (midi_vqgan_3d_gray), 4 (the
// vqgan recipes), 8 (audio_dac). The wrappers refuse any other D.
#define FUSED_VQ_CASES(X) X(3) X(4) X(8)

bool tail_args_ok(int B, int H, int W, int Din, int D, int groups) {
  return B >= 1 && H >= 1 && W >= 1 && Din >= 1 && D >= 1 && groups >= 1 && D % groups == 0 &&
         (long long)H * W <= 0x7fffffffLL;
}

}  // namespace

// K4. z (N, Din), w (Din, D), b (D,), cb (L, K, D) fp32 contiguous -> zq (N, D)
// fp32, idx (N, L) int32. Returns 0 (launched), kErrSharedMemory or a
// cudaError_t.
extern "C" int fused_compress_vq(const void* z, const void* w, const void* b, const void* cb,
                                 void* zq, void* idx, long long N, int Din, int D, int L, int K,
                                 void* stream) {
  if (N < 1 || Din < 1 || D < 1 || L < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_VQ_K4(N_)                                                                        \
  case N_:                                                                                     \
    return launch_compress_vq<N_>(                                                             \
        static_cast<const float*>(z), static_cast<const float*>(w),                            \
        static_cast<const float*>(b), static_cast<const float*>(cb), static_cast<float*>(zq), \
        static_cast<int*>(idx), N, Din, L, K, s);
  switch (D) {
    FUSED_VQ_CASES(FUSED_VQ_K4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_VQ_K4
}

// K3. h (B, H, W, Din) read by the strides sb (image), sc (channel) and sp
// (pixel, p = y*W + x); w1 (D, Din); b1, gs, gb, cbias (D,); cw (D, D, 3, 3)
// OIHW; cb (L, K, D) -> zq (B*H*W, D) fp32, idx (B*H*W, L) int32.
extern "C" int fused_compress_tail_vq(const void* h, long long sb, long long sc, long long sp,
                                      int B, int H, int W, int Din, const void* w1,
                                      const void* b1, const void* gs, const void* gb,
                                      const void* cw, const void* cbias, const void* cb, int D,
                                      int L, int K, int groups, float eps, void* zq, void* idx,
                                      void* stream) {
  if (!tail_args_ok(B, H, W, Din, D, groups) || L < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_VQ_K3(N_)                                                                          \
  case N_:                                                                                       \
    return launch_tail<N_, true>(                                                                \
        static_cast<const float*>(h), sb, sc, sp, B, H, W, Din, static_cast<const float*>(w1),   \
        static_cast<const float*>(b1), static_cast<const float*>(gs),                            \
        static_cast<const float*>(gb), static_cast<const float*>(cw),                            \
        static_cast<const float*>(cbias), static_cast<const float*>(cb), L, K, groups, eps,      \
        static_cast<float*>(zq), static_cast<int*>(idx), nullptr, nullptr, nullptr, s);
  switch (D) {
    FUSED_VQ_CASES(FUSED_VQ_K3)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_VQ_K3
}

// K5. Inputs as K3 without the codebooks -> y1, y2, out, each (B*H*W, D) fp32.
extern "C" int compress_tail_debug(const void* h, long long sb, long long sc, long long sp, int B,
                                   int H, int W, int Din, const void* w1, const void* b1,
                                   const void* gs, const void* gb, const void* cw,
                                   const void* cbias, int D, int groups, float eps, void* y1,
                                   void* y2, void* out, void* stream) {
  if (!tail_args_ok(B, H, W, Din, D, groups)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_VQ_K5(N_)                                                                          \
  case N_:                                                                                       \
    return launch_tail<N_, false>(                                                               \
        static_cast<const float*>(h), sb, sc, sp, B, H, W, Din, static_cast<const float*>(w1),   \
        static_cast<const float*>(b1), static_cast<const float*>(gs),                            \
        static_cast<const float*>(gb), static_cast<const float*>(cw),                            \
        static_cast<const float*>(cbias), nullptr, 0, 0, groups, eps, nullptr, nullptr,          \
        static_cast<float*>(y1), static_cast<float*>(y2), static_cast<float*>(out), s);
  switch (D) {
    FUSED_VQ_CASES(FUSED_VQ_K5)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_VQ_K5
}
