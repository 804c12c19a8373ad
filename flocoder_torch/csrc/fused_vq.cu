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
// K3 and K5 are one templated kernel (tail_kernel<D, kSearch, T>); K3 and K4
// share one search (group_search). K3 reads h in fp32 or bf16 (T; a bf16
// codec hands over bf16 activations), as the TPU kernel does, and widens each
// value to fp32 where the 1x1 projection reads it from shared memory; its
// z_q is stored in h's dtype (bf16 rounded to nearest even). Every other
// value is fp32 end to end, and the distances are ||r||^2 + ||c||^2 - 2 r.c
// with the first minimum on ties, as in the TPU kernels, so the picks agree
// with an fp64 oracle up to ties inside fp32 rounding; from the same bf16 h
// the arithmetic is that of the fp32 kernel on h widened.
//
// What bounds them on an H100: at the pre-encode shape (B=32, 16x16, Din=128,
// D=4, L=4, K=96) K3 reads 4.2 MB of activations and writes 0.25 MB, about
// 1.3 us at 3.35 TB/s, and does ~40 MFLOP of search and ~35 MFLOP of
// projection, far under either peak. A launch of this size is bound by
// latency: the launch itself, how many SMs work, how many loads each has in
// flight, and the chain of dependent steps between the read of h and the
// last pick. The design:
//
// - K3/K5: a thread-block cluster per image. The GroupNorm statistics are
//   per image, so one block per image would use 32 of 132 SMs at B=32;
//   instead the image's rows are cut into bands, one band per block of 128
//   threads in a cluster of 1, 2, 4 or 8 (8 at B=32: 256 small blocks, about
//   two per SM; the band plan comes from the wrapper,
//   flocoder_torch/ops/kernels/fused_vq.py:plan_bands, and is checked here).
//   Each block starts two groups of asynchronous copies (cp.async): first
//   its band of h (16-byte runs of 4 fp32 or 8 bf16 tokens for NCHW memory,
//   what the codec's convolutions leave; 4-byte copies through the strides
//   otherwise, or plain loads of 2-byte bf16 values, which cp.async cannot
//   copy one at a time; in chunks of channels that fit 64 KB), w1 and the small
//   parameters, then the 3x3 weights and the codebooks. The 1x1 projection multiplies 4-token x D
//   tiles out of shared memory, the threads of a tile splitting Din and
//   reducing with shuffles and then across warps in warp order, into the
//   band map ([D][rows+2][W+2]: a halo row above and below and a zero column
//   left and right). GroupNorm: warp 0 takes the band's group sums and,
//   around the band's own mean, its squared deviations (two passes over
//   shared memory), and writes (sum, M2, mean, count) into every block of
//   the cluster through distributed shared memory; after a cluster barrier
//   each block merges the cluster's partials (Chan: M2 = sum M2_r + n_r (m_r
//   - m)^2) in a fixed shuffle tree, so the statistics are deterministic,
//   the same in every block and as exact as two passes over the whole
//   image. SiLU then runs a thread per value (__expf and __fdividef, a few
//   ulp) and writes the band's first and
//   last rows into the neighbours' halo rows (the image's edges stay zero);
//   after a second cluster barrier the 3x3 convolution runs a thread per
//   (token, channel) without a branch, and the search follows. A block only
//   writes into other blocks' shared memory before the second barrier and
//   never reads it, so no block waits for another to finish. Blocks with no
//   rows (an image of fewer rows than the cluster has blocks) take part in
//   both barriers and write nothing.
// - The search splits each level's codes across an aligned group of G lanes
//   (G = 1..32, a power of two, a template parameter) that holds kTok
//   tokens: lane j loads codes j, j + G, ... once and scores each against
//   every token of its group with the distance expression above (the dot an
//   fma chain over d in order) and a strict <, into kChains running minima
//   per token; it merges them, and the group merges its lanes' with xor
//   shuffles, the other pair winning only if its distance is smaller, or
//   equal with a smaller index: the first minimum, exactly as a serial scan
//   finds it. Each level is padded with NaN codes to a multiple of kChains *
//   G, so the scan has no guard; a NaN distance never wins, and if no code
//   has a distance below +inf (a NaN token) the level picks nothing: index
//   0 and nothing added, as the TPU kernels' all-zero one-hot. Every lane
//   then applies the same pick to the residual. A token's chain drops from K steps to
//   K / (kChains * G) + log2 G per level.
// - Index arithmetic divides through a float reciprocal with an exact
//   correction (div_by): the card has no integer divider, and a / b by a
//   runtime b is a long dependent sequence at the start of every phase.
// - K4: a block of 256 threads per 64 tokens, 8 lanes for every 2 tokens:
//   the lanes read the tokens' rows as float4 (when Din % 4 == 0 and the
//   rows are 16-byte aligned; a scalar loop otherwise) with w's rows,
//   reduce the D sums with shuffles, and the same lanes search the tokens.
// - The codebooks and their squared norms sit in each block's shared memory
//   (6 KB at L=4, K=96, D=4; 24 KB at 3x512x4), staged by cp.async.
//
// Plain C interface (bound with ctypes). The wrappers in
// flocoder_torch/ops/kernels/fused_vq.py validate dtypes, shapes, D, groups,
// layouts and devices, allocate the outputs and raise if the return code is
// not 0. Shared memory is worked out here alone: a block that would need
// more than a Hopper block may have (a band map too large for one block of
// the cluster) returns kErrSharedMemory, which the wrappers raise as a
// ValueError. Only the D values of the repo's configs are instantiated
// (FUSED_VQ_CASES); any other D returns cudaErrorInvalidValue.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;                      // K3/K5: threads per block
constexpr int kK4Threads = 256;                    // K4: threads per block
constexpr int kTok = 2;                            // tokens a lane scores per code it loads
constexpr int kChains = 2;                         // running minima per token and lane
constexpr int kK4Lanes = 8;                        // K4: lanes per token
constexpr int kK4Tokens = kK4Threads / kK4Lanes * kTok;  // K4: tokens per block
constexpr int kMaxCluster = 8;                     // the portable cluster size
constexpr size_t kMaxSmem = 232448;                // 227 KB, the most a block may use
constexpr unsigned kFull = 0xffffffffu;
constexpr int kErrSharedMemory = -1;               // outside cudaError_t's range
constexpr int kNoCode = 0x7fffffff;                // a lane that found no code below +inf

__host__ __device__ constexpr size_t round4(size_t n) { return (n + 3) & ~(size_t)3; }

// The codes of a level padded to a multiple of kChains * g (g lanes a token),
// so that the search loop has no guard.
__host__ __device__ constexpr int padded_codes(int K, int g) {
  return (K + kChains * g - 1) / (kChains * g) * (kChains * g);
}

// a / b for 0 <= a < 2^22 and b >= 1, by b's float reciprocal inv (1.f / b,
// taken once): the product is within one of the quotient, and one step
// each way makes it exact. Hardware has no integer divider; this is a few
// instructions where a / b is a long dependent sequence.
__device__ __forceinline__ int div_by(int a, int b, float inv) {
  int q = __float2int_rz((float)a * inv);
  const int r = a - q * b;
  q += (r >= b) - (r < 0);
  return q;
}

// D consecutive floats, 16-byte aligned when D % 4 == 0 (a staged code, or a
// row of K4's weight).
template <int D>
__device__ __forceinline__ void load_row(const float* p, float (&c)[D]) {
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int q = 0; q < D / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) c[d] = p[d];
  }
}

// Asynchronous copies from device to shared memory (cp.async), 16 or 4
// bytes; cp_async_wait_all waits for this thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// Closes this thread's group of copies; cp_async_wait_prior waits for all but
// the last group.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Starts copying n floats from src into shared dst (16-byte aligned), by the
// whole block, without waiting.
__device__ __forceinline__ void copy_async(float* dst, const float* __restrict__ src, int n) {
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) cp_async16(dst + 4 * i, src + 4 * i);
    i0 = n / 4 * 4;
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x) cp_async4(dst + i, src + i);
}

// Starts copying the L codebooks (L, K, D) into shared memory, level l at
// s_cb + l*Kp*D, and fills each level's Kp - K padding codes with NaN: a NaN
// distance never wins. The caller waits (cp_async_wait_all) and
// synchronises the block before reading them.
template <int D>
__device__ __forceinline__ void stage_codebooks(const float* __restrict__ cb, int L, int K,
                                                int Kp, float* s_cb) {
  if (Kp == K) {
    copy_async(s_cb, cb, L * K * D);
    return;
  }
  for (int l = 0; l < L; ++l) copy_async(s_cb + (size_t)l * Kp * D, cb + (size_t)l * K * D, K * D);
  const int pad = (Kp - K) * D;
  for (int i = threadIdx.x; i < L * pad; i += blockDim.x) {
    const int l = i / pad;
    s_cb[(size_t)l * Kp * D + K * D + (i - l * pad)] = NAN;
  }
}

// Each staged code's squared norm, a thread per code.
template <int D>
__device__ __forceinline__ void code_norms(const float* s_cb, int n_codes, float* s_c2) {
  for (int j = threadIdx.x; j < n_codes; j += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(s_cb[j * D + d], s_cb[j * D + d], s);
    s_c2[j] = s;
  }
}

// Greedy RVQ of kTok tokens' D values r[t], each held alike by the G lanes
// of an aligned group (j = this lane's place in it), over L staged levels of
// Kp codes (K real ones, then NaN padding). At each level the code with the
// least (||r||^2 + ||c||^2) - 2 r.c, the first one on ties, is subtracted
// from the residual. A lane loads codes j, j + G, ... once and scores each
// against all kTok tokens, keeping kChains running minima per token (chain u
// holds codes j + u*G + kChains*G*m, so that the compares of different
// chains overlap); it merges its chains, then the group merges its lanes'
// with xor shuffles. A pair (dist, index) replaces another only if its
// distance is smaller, or equal with a smaller index: the first minimum. A
// NaN distance never wins; no code below +inf picks nothing (index 0, no
// code added). Writes z_q (the exact sum of the picked codes) and the L indices of each token t with
// live[t] at zq + tok[t]*D and idx + tok[t]*L, spread over the group's
// lanes. Every lane of the warp must call it (it shuffles with the full
// mask).
// z_q in fp32 or bf16 (rounded to nearest even): the stored value.
__device__ __forceinline__ void store_value(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_value(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D, int G, typename ZT>
__device__ __forceinline__ void group_search(float (&r)[kTok][D], int j, const float* s_cb,
                                             const float* s_c2, int L, int Kp,
                                             const bool (&live)[kTok],
                                             const long long (&tok)[kTok],
                                             ZT* __restrict__ zq, int* __restrict__ idx) {
  float acc[kTok][D];
#pragma unroll
  for (int t = 0; t < kTok; ++t)
#pragma unroll
    for (int d = 0; d < D; ++d) acc[t][d] = 0.f;
  for (int l = 0; l < L; ++l) {
    const float* c = s_cb + (size_t)l * Kp * D;
    const float* c2 = s_c2 + (size_t)l * Kp;
    float r2[kTok], best[kTok][kChains];
    int bis[kTok][kChains];
#pragma unroll
    for (int t = 0; t < kTok; ++t) {
      r2[t] = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) r2[t] = fmaf(r[t][d], r[t][d], r2[t]);
#pragma unroll
      for (int u = 0; u < kChains; ++u) {
        best[t][u] = INFINITY;
        bis[t][u] = kNoCode;
      }
    }
    for (int k0 = j; k0 < Kp; k0 += kChains * G) {
#pragma unroll
      for (int u = 0; u < kChains; ++u) {
        const int k = k0 + u * G;
        float cv[D];
        load_row<D>(c + k * D, cv);
        const float ck = c2[k];
#pragma unroll
        for (int t = 0; t < kTok; ++t) {
          float dot = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) dot = fmaf(r[t][d], cv[d], dot);
          const float dist = fmaf(-2.f, dot, r2[t] + ck);   // (r2 + c2) - 2 dot
          if (dist < best[t][u]) {
            best[t][u] = dist;
            bis[t][u] = k;
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTok; ++t) {
      float b = best[t][0];
      int bi = bis[t][0];
#pragma unroll
      for (int u = 1; u < kChains; ++u) {
        if (best[t][u] < b || (best[t][u] == b && bis[t][u] < bi)) {
          b = best[t][u];
          bi = bis[t][u];
        }
      }
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
        const float ob = __shfl_xor_sync(kFull, b, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (ob < b || (ob == b && oi < bi)) {
          b = ob;
          bi = oi;
        }
      }
      // no code won (every distance NaN: a NaN token): as the TPU kernels'
      // all-zero one-hot, the level adds nothing and records index 0
      if (bi == kNoCode) {
        bi = 0;
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float q = c[bi * D + d];
          acc[t][d] += q;
          r[t][d] -= q;
        }
      }
      if (live[t] && l % G == j) idx[tok[t] * L + l] = bi;
    }
  }
#pragma unroll
  for (int t = 0; t < kTok; ++t) {
    if (live[t]) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        if (d % G == j) store_value(zq + tok[t] * D + d, acc[t][d]);
    }
  }
}

// ---------------------------------------------------------------- K4

// A block of kK4Threads threads per kK4Tokens tokens, kK4Lanes lanes a token
// and kTok tokens a group. Shared memory: the padded codebooks [L*Kp][D],
// their squared norms [L*Kp], and b [D].
template <int D>
__global__ void __launch_bounds__(kK4Threads, 2)
compress_vq_kernel(const float* __restrict__ z, const float* __restrict__ w,
                   const float* __restrict__ b, const float* __restrict__ cb,
                   float* __restrict__ zq, int* __restrict__ idx, long long N, int Din,
                   int L, int K, bool vec) {
  extern __shared__ float4 smem4[];
  const int Kp = padded_codes(K, kK4Lanes);
  float* s_cb = reinterpret_cast<float*>(smem4);
  float* s_c2 = s_cb + (size_t)L * Kp * D;
  float* s_b = s_c2 + round4((size_t)L * Kp);
  stage_codebooks<D>(cb, L, K, Kp, s_cb);
  copy_async(s_b, b, D);

  const int j = threadIdx.x & (kK4Lanes - 1);
  long long tok[kTok];
  bool live[kTok];
  float acc[kTok][D];
#pragma unroll
  for (int t = 0; t < kTok; ++t) {
    tok[t] = (long long)blockIdx.x * kK4Tokens + t * (kK4Threads / kK4Lanes) +
             threadIdx.x / kK4Lanes;
    live[t] = tok[t] < N;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[t][d] = 0.f;
  }
  const bool w4 = D % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  if (vec) {  // Din % 4 == 0 and 16-byte aligned rows: float4 runs, kB a lane at a time
    constexpr int kB = D > 4 ? 2 : 4;
    for (int c0 = 4 * j; c0 < Din; c0 += 4 * kK4Lanes * kB) {
      float v[kTok][kB][4], wr[kB][4][D];
#pragma unroll
      for (int q = 0; q < kB; ++q) {
        const int c = c0 + 4 * kK4Lanes * q;
        const bool in = c < Din;
        const int cc = in ? c : Din - 4;
#pragma unroll
        for (int t = 0; t < kTok; ++t) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(
              z + (live[t] ? tok[t] : 0) * Din + cc));
          const bool ok = in && live[t];
          v[t][q][0] = ok ? x.x : 0.f;
          v[t][q][1] = ok ? x.y : 0.f;
          v[t][q][2] = ok ? x.z : 0.f;
          v[t][q][3] = ok ? x.w : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (w4) {
            load_row<D>(w + (size_t)(cc + e) * D, wr[q][e]);
          } else {
#pragma unroll
            for (int d = 0; d < D; ++d) wr[q][e][d] = __ldg(w + (size_t)(cc + e) * D + d);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kB; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int t = 0; t < kTok; ++t)
#pragma unroll
            for (int d = 0; d < D; ++d) acc[t][d] = fmaf(v[t][q][e], wr[q][e][d], acc[t][d]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < kTok; ++t) {
      if (!live[t]) continue;
      const float* row = z + tok[t] * Din;
      for (int c = j; c < Din; c += kK4Lanes) {
        const float v = __ldg(row + c);
#pragma unroll
        for (int d = 0; d < D; ++d) acc[t][d] = fmaf(v, __ldg(w + (size_t)c * D + d), acc[t][d]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kTok; ++t)
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int off = 1; off < kK4Lanes; off <<= 1)
        acc[t][d] += __shfl_xor_sync(kFull, acc[t][d], off);
    }
  cp_async_wait_all();
  __syncthreads();  // the codebooks and b are staged
  float r[kTok][D];
#pragma unroll
  for (int t = 0; t < kTok; ++t)
#pragma unroll
    for (int d = 0; d < D; ++d) r[t][d] = acc[t][d] + s_b[d];
  code_norms<D>(s_cb, L * Kp, s_c2);
  __syncthreads();
  group_search<D, kK4Lanes, float>(r, j, s_cb, s_c2, L, Kp, live, tok, zq, idx);
}

// ---------------------------------------------------------------- K3, K5

// The block's shared memory, in floats from the (16-byte aligned) base: the
// padded codebooks and their squared norms (K3 only), the 3x3 weights, w1
// [D][Din], b1, the GroupNorm scale and shift and the 3x3's bias [4][D],
// every block's GroupNorm partials [kMaxCluster][4*D] (group sum, M2 around
// the band's mean, the band's mean, count; each block writes its own into
// every block of the cluster), the merged statistics [2][D], the band map
// [D][rows+2][W+2] (a halo row above and below and a zero column left and
// right, so that the 3x3 reads its neighbourhood without a branch), the
// convolution's output [D][rows*W] (K3 only), the projection's reduction
// scratch [kThreads][4][D], and a chunk of CC of the band's h channels
// [CC][BT] in h's type of `esize` bytes (all of them when kHChunk bytes hold
// them; a channel's row is a whole number of 16-byte runs). Offsets are in
// floats up to h; `bytes` is the total.
constexpr int kHChunk = 65536;                     // bytes
struct TailLayout {
  size_t cb, c2, cw, w1, prm, part, gn, y, out, red, h, bytes;
  int BT, CC;
  __host__ __device__ TailLayout(int D, int rows, int W, int Din, int L, int Kp, bool search,
                                 int esize) {
    const size_t run = 16 / esize;                 // values a 16-byte run holds
    BT = (int)(((size_t)rows * W + run - 1) / run * run);
    const int fit = kHChunk / (BT * esize);
    CC = fit < Din ? (fit > 1 ? fit : 1) : Din;
    cb = 0;
    c2 = cb + round4((size_t)L * Kp * D);
    cw = c2 + round4((size_t)L * Kp);
    w1 = cw + round4((size_t)9 * D * D);
    prm = w1 + round4((size_t)D * Din);
    part = prm + round4((size_t)4 * D);
    gn = part + (size_t)kMaxCluster * 4 * D;
    y = gn + round4((size_t)2 * D);
    out = y + round4((size_t)D * (rows + 2) * (W + 2));
    red = out + (search ? round4((size_t)D * rows * W) : 0);
    h = red + (size_t)kThreads * 4 * D;
    bytes = sizeof(float) * h + (size_t)CC * BT * esize;
  }
};

// Sums v[0..D) over a warp; every lane gets the totals.
template <int D>
__device__ __forceinline__ void warp_sum(float (&v)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[d] += __shfl_xor_sync(kFull, v[d], off);
  }
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

// One value of h into shared memory: a 4-byte cp.async for fp32; a plain
// load and store for bf16 (cp.async copies 4, 8 or 16 bytes), which the
// __syncthreads after the copies' wait makes visible alike.
__device__ __forceinline__ void stage_value(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void stage_value(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  *dst = *src;
}

// Starts copying channels [0, nc) of the band's h (n_tok tokens, read as
// hb[c*sc + t*sp], t the token's place in the band) into s_h [nc][BT]:
// 16-byte copies of 16 / sizeof(T) tokens when vec (sp == 1, 16-byte
// aligned runs), else a value at a time in the order of the smaller stride,
// so that neighbouring threads read neighbouring addresses.
template <typename T>
__device__ __forceinline__ void stage_band(const T* __restrict__ hb, long long sc, long long sp,
                                           int n_tok, int nc, int BT, bool vec, T* s_h) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int nq = n_tok / E;
    if (nq == 0) return;
    const float inv = 1.f / (float)nq;
    for (int i = threadIdx.x; i < nc * nq; i += kThreads) {
      const int c = div_by(i, nq, inv);
      const int q = i - c * nq;
      cp_async16(s_h + c * BT + E * q, hb + c * sc + E * q);
    }
  } else if (sc == 1) {
    const float inv = 1.f / (float)nc;
    for (int i = threadIdx.x; i < nc * n_tok; i += kThreads) {
      const int t = div_by(i, nc, inv);
      const int c = i - t * nc;
      stage_value(s_h + c * BT + t, hb + t * sp + c);
    }
  } else {
    if (n_tok == 0) return;
    const float inv = 1.f / (float)n_tok;
    for (int i = threadIdx.x; i < nc * n_tok; i += kThreads) {
      const int c = div_by(i, n_tok, inv);
      const int t = i - c * n_tok;
      stage_value(s_h + c * BT + t, hb + c * sc + t * sp);
    }
  }
}

// Four consecutive staged values of h, widened to fp32 (16 bytes of fp32, 8
// of bf16, aligned to their size).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// One chunk of the 1x1 projection, channels [c0, c0 + nc) staged in s_h
// [nc][BT]. A unit is 4 consecutive tokens, read together from each
// channel's row and widened to fp32 (load4); Q units (a power of two up to 32) per pass, and the
// kThreads / Q threads that share a unit split the chunk into runs of
// consecutive channels, each thread multiplying its run into a 4 x D tile
// of partial sums. Those are added with shuffles inside each warp and then
// across warps in warp order, through s_red. The first chunk stores the sum
// at token t's place in the padded map, yb[d*SW + (t/W)*(W+2) + t%W], later
// chunks add to it; the last chunk adds b1 (and writes y1 in K5). Every
// thread of the block calls it.
template <int D, bool kDebug, typename T>
__device__ __forceinline__ void project_chunk(const T* s_h, int BT, int n_tok, int W,
                                              int Din, int c0, int nc, const float* s_w1,
                                              const float* s_b1, float* yb, int SW,
                                              float* s_red, float* __restrict__ y1_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_units = (n_tok + 3) / 4;
  int Q = 1;
  while (Q < n_units && Q < 32) Q <<= 1;
  const int S = kThreads / Q;                      // channel splits
  const int s = lane / Q + (32 / Q) * warp;        // this thread's split
  const int u_in = lane & (Q - 1);
  const int Cr = (nc + S - 1) / S;                 // channels a split
  const int c_lo = min(nc, s * Cr);
  const int c_hi = min(nc, c_lo + Cr);
  const float inv_w = 1.f / (float)W;
  for (int u0 = 0; u0 < n_units; u0 += Q) {
    const int u = u0 + u_in;
    float acc[4][D];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int d = 0; d < D; ++d) acc[i][d] = 0.f;
    if (u < n_units) {
#pragma unroll 4
      for (int c = c_lo; c < c_hi; ++c) {
        float v[4];
        load4(s_h + c * BT + 4 * u, v);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float wd = s_w1[d * Din + c0 + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][d] = fmaf(v[i], wd, acc[i][d]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int d = 0; d < D; ++d)
        for (int off = Q; off < 32; off <<= 1)
          acc[i][d] += __shfl_xor_sync(kFull, acc[i][d], off);
    if (lane < Q) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int d = 0; d < D; ++d) s_red[((warp * Q + lane) * 4 + i) * D + d] = acc[i][d];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < Q * 4 * D; e += kThreads) {
      const int d = e % D;
      const int ui = e / D;                        // unit in pass * 4 + token in unit
      const int t = u0 * 4 + ui;
      if (t < n_tok) {
        float sum = 0.f;
        for (int wp = 0; wp < kThreads / 32; ++wp) sum += s_red[(wp * Q * 4 + ui) * D + d];
        const int ty = div_by(t, W, inv_w);
        float* y = yb + d * SW + ty * (W + 2) + (t - ty * W);
        if (c0 > 0) sum += *y;
        if (c0 + nc >= Din) {
          sum += s_b1[d];
          if (kDebug) y1_out[(long long)t * D + d] = sum;
        }
        *y = sum;
      }
    }
    __syncthreads();                               // s_red is reused
  }
}

// The search of a band's n_tok tokens, their 3x3 outputs in s_out
// [D][RW]: G lanes for every kTok tokens, as many tokens a pass as the
// block holds. Every thread of the block calls it.
template <int D, int G, typename ZT>
__device__ __forceinline__ void search_band(const float* s_out, int RW, int n_tok,
                                            long long tok0, const float* s_cb,
                                            const float* s_c2, int L, int Kp,
                                            ZT* __restrict__ zq, int* __restrict__ idx) {
  constexpr int kGroups = kThreads / G;
  const int j = threadIdx.x & (G - 1);
  for (int t0 = 0; t0 < n_tok; t0 += kGroups * kTok) {
    float r[kTok][D];
    bool live[kTok];
    long long tok[kTok];
#pragma unroll
    for (int a = 0; a < kTok; ++a) {
      const int t = t0 + a * kGroups + threadIdx.x / G;
      live[a] = t < n_tok;
      tok[a] = tok0 + (live[a] ? t : 0);
#pragma unroll
      for (int d = 0; d < D; ++d) r[a][d] = live[a] ? s_out[d * RW + t] : 0.f;
    }
    group_search<D, G, ZT>(r, j, s_cb, s_c2, L, Kp, live, tok, zq, idx);
  }
}

// K3 (kSearch) and K5 (!kSearch): a cluster of blocks per image, each block
// a band of `rows` rows (fewer for the last band, none past the image). h is
// read as h[img*sb + c*sc + p*sp] with p = y*W + x, in T (fp32 or bf16);
// z_q is written in T; vec says that sp == 1 and that every band row starts
// 16-byte aligned. w1 is the 1x1 conv's (D,
// Din) weight, cw the 3x3 conv's OIHW (D, D, 3, 3) weight. The search uses
// `lanes` lanes for every kTok tokens. Every thread reaches both cluster
// barriers; a block writes into the other blocks' shared memory only before
// the second, and never reads it, so after the second barrier no block
// depends on another and each exits when it is done.
template <int D, bool kSearch, typename T>
__global__ void __launch_bounds__(kThreads, 4)
tail_kernel(const T* __restrict__ h, long long sb, long long sc, long long sp, int H, int W,
            int Din, int rows, int lanes, bool vec, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ gs,
            const float* __restrict__ gb, const float* __restrict__ cw,
            const float* __restrict__ cbias, const float* __restrict__ cb, int L, int K,
            int groups, float eps, T* __restrict__ zq, int* __restrict__ idx,
            float* __restrict__ y1_out, float* __restrict__ y2_out,
            float* __restrict__ conv_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const long long img = blockIdx.x / cs;
  const int r0 = min(H, rank * rows);
  const int r1 = min(H, r0 + rows);
  const int nrows = r1 - r0;
  const int n_tok = nrows * W;
  const int PW = W + 2;                            // a padded row
  const int SW = (rows + 2) * PW;                  // a channel's stride in s_y
  const int RW = rows * W;                         // a channel's stride in s_out
  const int Kp = kSearch ? padded_codes(K, lanes) : 0;
  const TailLayout lay(D, rows, W, Din, kSearch ? L : 0, Kp, kSearch, (int)sizeof(T));
  float* s_cb = smem + lay.cb;
  float* s_c2 = smem + lay.c2;
  float* s_cw = smem + lay.cw;
  float* s_w1 = smem + lay.w1;
  float* s_prm = smem + lay.prm;                   // b1, gs, gb, cbias
  float* s_part = smem + lay.part;
  float* s_gn = smem + lay.gn;
  float* s_y = smem + lay.y;
  float* s_out = smem + lay.out;
  float* s_red = smem + lay.red;
  T* s_h = reinterpret_cast<T*>(smem + lay.h);
  const int tid = threadIdx.x;
  const long long tok0 = img * H * W + (long long)r0 * W;   // the band's first token
  const float inv_w = 1.f / (float)W;
  const float inv_n = n_tok > 0 ? 1.f / (float)n_tok : 0.f;

  // copies in two groups: what the projection needs first, then the rest
  const T* hb = h + img * sb + (long long)r0 * W * sp;
  const int CC = lay.CC;
  stage_band(hb, sc, sp, n_tok, min(CC, Din), lay.BT, vec, s_h);
  copy_async(s_w1, w1, D * Din);
  copy_async(s_prm, b1, D);
  copy_async(s_prm + D, gs, D);
  copy_async(s_prm + 2 * D, gb, D);
  copy_async(s_prm + 3 * D, cbias, D);
  cp_async_commit();
  copy_async(s_cw, cw, 9 * D * D);
  if (kSearch) stage_codebooks<D>(cb, L, K, Kp, s_cb);
  cp_async_commit();
  // zeros: the pad columns of every row, and the halo rows at the image's
  // top and bottom edges (the neighbours write the other halo rows)
  for (int e = tid; e < D * (rows + 2); e += kThreads) {
    s_y[e * PW] = 0.f;
    s_y[e * PW + W + 1] = 0.f;
  }
  for (int e = tid; e < D * W; e += kThreads) {
    const int d = div_by(e, W, inv_w);
    const int x = e - d * W + 1;
    if (r0 == 0) s_y[d * SW + x] = 0.f;
    if (r1 == H) s_y[d * SW + (nrows + 1) * PW + x] = 0.f;
  }
  cp_async_wait_prior();
  __syncthreads();                                 // h's first chunk, w1, the parameters

  // 1x1 projection of the band into rows 1..nrows, columns 1..W of s_y, a
  // chunk of CC channels at a time (one chunk at the codec's shapes)
  float* yb = s_y + PW + 1;
  for (int c0 = 0; c0 < Din; c0 += CC) {
    if (c0 > 0) {
      stage_band(hb + c0 * sc, sc, sp, n_tok, min(CC, Din - c0), lay.BT, vec, s_h);
      cp_async_wait_all();
      __syncthreads();
    }
    project_chunk<D, !kSearch>(s_h, lay.BT, n_tok, W, Din, c0, min(CC, Din - c0), s_w1, s_prm,
                               yb, SW, s_red, kSearch ? nullptr : y1_out + tok0 * D);
  }

  // GroupNorm partials of the band, by warp 0: the group sums, then M2
  // around the band's own mean (two passes over shared memory), put into
  // every block's s_part at this block's rank
  const int gsz = D / groups;
  if (tid < 32) {
    float part[D], gsum[D], gm2[D], m[D];
#pragma unroll
    for (int d = 0; d < D; ++d) part[d] = 0.f;
    for (int t = tid; t < n_tok; t += 32) {
      const int ty = div_by(t, W, inv_w);
      const int q = ty * PW + (t - ty * W);
#pragma unroll
      for (int d = 0; d < D; ++d) part[d] += yb[d * SW + q];
    }
    warp_sum<D>(part);
    group_totals<D>(part, gsz, gsum);
    const float n_band = (float)n_tok * (float)gsz;
    const float inv = n_tok > 0 ? 1.f / n_band : 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      m[d] = gsum[d] * inv;
      part[d] = 0.f;
    }
    for (int t = tid; t < n_tok; t += 32) {
      const int ty = div_by(t, W, inv_w);
      const int q = ty * PW + (t - ty * W);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float e = yb[d * SW + q] - m[d];
        part[d] = fmaf(e, e, part[d]);
      }
    }
    warp_sum<D>(part);
    group_totals<D>(part, gsz, gm2);
    if (tid < cs) {
      float* dst = cluster.map_shared_rank(s_part, tid) + rank * 4 * D;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dst[d] = gsum[d];
        dst[D + d] = gm2[d];
        dst[2 * D + d] = m[d];
      }
      dst[3 * D] = n_band;
    }
  }
  cluster.sync();

  // the cluster's partials merged (Chan) by warp 0, in lane groups of
  // kMaxCluster: lane q of group d holds rank q's partials of channel d, and
  // a fixed shuffle tree sums them, so every block gets the same statistics
  if (tid < 32) {
    const int q = tid % kMaxCluster;
    const bool have = q < cs;
    const float* pq = s_part + (have ? q : 0) * 4 * D;
    const float nq = have ? pq[3 * D] : 0.f;
    float n = nq;
    for (int off = 1; off < kMaxCluster; off <<= 1) n += __shfl_xor_sync(kFull, n, off);
    const float inv_n = 1.f / n;
    for (int d0 = 0; d0 < D; d0 += 32 / kMaxCluster) {
      const int d = d0 + tid / kMaxCluster;
      const bool ok = have && d < D;
      float sum = ok ? pq[d] : 0.f;
      for (int off = 1; off < kMaxCluster; off <<= 1) sum += __shfl_xor_sync(kFull, sum, off);
      const float mean = sum * inv_n;
      const float dm = ok ? pq[2 * D + d] - mean : 0.f;
      float m2 = ok ? pq[D + d] + nq * dm * dm : 0.f;
      for (int off = 1; off < kMaxCluster; off <<= 1) m2 += __shfl_xor_sync(kFull, m2, off);
      if (q == 0 && d < D) {
        s_gn[d] = mean;
        s_gn[D + d] = 1.f / sqrtf(m2 * inv_n + eps);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();                                 // s_gn, s_prm, s_cw and the codebooks
  if (kSearch) code_norms<D>(s_cb, L * Kp, s_c2);

  // normalise, scale and shift, SiLU, in place, a thread per (token,
  // channel); the band's first row also goes into the halo below rank - 1's
  // band, its last row into the halo above rank + 1's
  float* up = r0 > 0 && n_tok > 0 ? cluster.map_shared_rank(s_y, rank - 1) : nullptr;
  float* dn = r1 < H && n_tok > 0 ? cluster.map_shared_rank(s_y, rank + 1) : nullptr;
  for (int e = tid; e < n_tok * D; e += kThreads) {
    const int d = div_by(e, n_tok, inv_n);
    const int t = e - d * n_tok;
    const int ty = div_by(t, W, inv_w);
    const int x = t - ty * W + 1;
    const int q = d * SW + (ty + 1) * PW + x;
    float y = (s_y[q] - s_gn[d]) * s_gn[D + d] * s_prm[D + d] + s_prm[2 * D + d];
    y = __fdividef(y, 1.f + __expf(-y));           // ~2 ulp each, far inside 1e-5
    s_y[q] = y;
    if (ty == 0 && up) up[d * SW + (rows + 1) * PW + x] = y;
    if (ty == nrows - 1 && dn) dn[d * SW + x] = y;
    if (!kSearch) y2_out[(tok0 + t) * D + d] = y;
  }
  cluster.sync();                                  // the halos and the norms are in

  // 3x3 convolution, a thread per (token, output channel), over the padded
  // map (zero outside the image)
  for (int e = tid; e < n_tok * D; e += kThreads) {
    const int o = div_by(e, n_tok, inv_n);
    const int t = e - o * n_tok;
    const int ty = div_by(t, W, inv_w);
    const float* y0 = s_y + ty * PW + (t - ty * W);
    const float* w0 = s_cw + o * D * 9;
    float acc = s_prm[3 * D + o];
#pragma unroll
    for (int ky = 0; ky < 3; ++ky)
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int i = 0; i < D; ++i)
          acc = fmaf(y0[i * SW + ky * PW + kx], w0[(i * 3 + ky) * 3 + kx], acc);
    if (kSearch)
      s_out[o * RW + t] = acc;
    else
      conv_out[(tok0 + t) * D + o] = acc;
  }
  if (!kSearch) return;
  __syncthreads();

  // the search: `lanes` lanes for every kTok tokens
  switch (lanes) {
    case 1: search_band<D, 1, T>(s_out, RW, n_tok, tok0, s_cb, s_c2, L, Kp, zq, idx); break;
    case 2: search_band<D, 2, T>(s_out, RW, n_tok, tok0, s_cb, s_c2, L, Kp, zq, idx); break;
    case 4: search_band<D, 4, T>(s_out, RW, n_tok, tok0, s_cb, s_c2, L, Kp, zq, idx); break;
    case 8: search_band<D, 8, T>(s_out, RW, n_tok, tok0, s_cb, s_c2, L, Kp, zq, idx); break;
    case 16: search_band<D, 16, T>(s_out, RW, n_tok, tok0, s_cb, s_c2, L, Kp, zq, idx); break;
    default: search_band<D, 32, T>(s_out, RW, n_tok, tok0, s_cb, s_c2, L, Kp, zq, idx); break;
  }
}

// 0, kErrSharedMemory, or the cudaError_t of raising the kernel's limit on
// the current device (raised once per device to the largest size asked).
constexpr int kMaxDevices = 64;
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem, size_t (&allowed)[kMaxDevices]) {
  if (smem > kMaxSmem) return kErrSharedMemory;
  if (smem <= 48 * 1024) return 0;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && smem <= allowed[dev]) return 0;
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == 0 && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

template <int D>
int launch_compress_vq(const float* z, const float* w, const float* b, const float* cb, float* zq,
                       int* idx, long long N, int Din, int L, int K, cudaStream_t s) {
  static size_t allowed[kMaxDevices] = {};
  const size_t Kp = padded_codes(K, kK4Lanes);
  const size_t smem =
      sizeof(float) * ((size_t)L * Kp * D + round4((size_t)L * Kp) + round4((size_t)D));
  const int err = allow_smem(compress_vq_kernel<D>, smem, allowed);
  if (err != 0) return err;
  const long long blocks = (N + kK4Tokens - 1) / kK4Tokens;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const bool vec = Din % 4 == 0 && ((uintptr_t)z & 15) == 0;
  compress_vq_kernel<D><<<(unsigned)blocks, kK4Threads, smem, s>>>(z, w, b, cb, zq, idx, N, Din,
                                                                   L, K, vec);
  return (int)cudaGetLastError();
}

template <int D, bool kSearch, typename T>
int launch_tail(const T* h, long long sb, long long sc, long long sp, int B, int H, int W,
                int Din, int cluster, int rows, int lanes, const float* w1, const float* b1,
                const float* gs, const float* gb, const float* cw, const float* cbias,
                const float* cb, int L, int K, int groups, float eps, T* zq, int* idx,
                float* y1, float* y2, float* out, cudaStream_t s) {
  static size_t allowed[kMaxDevices] = {};
  const int Kp = kSearch ? padded_codes(K, lanes) : 0;
  const size_t smem =
      TailLayout(D, rows, W, Din, kSearch ? L : 0, Kp, kSearch, (int)sizeof(T)).bytes;
  const int err = allow_smem(tail_kernel<D, kSearch, T>, smem, allowed);
  if (err != 0) return err;
  if ((long long)B * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  constexpr int E = 16 / sizeof(T);                // values in a 16-byte run
  const bool vec = sp == 1 && W % E == 0 && sc % E == 0 && sb % E == 0 &&
                   ((uintptr_t)h & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * cluster), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, tail_kernel<D, kSearch, T>, h, sb, sc, sp, H, W,
                                           Din, rows, lanes, vec, w1, b1, gs, gb, cw, cbias, cb,
                                           L, K, groups, eps, zq, idx, y1, y2, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Blocks of kThreads threads that only meet once at a cluster barrier: the
// least device time of a launch shaped like K3's.
__global__ void __launch_bounds__(kThreads) empty_cluster_kernel() { cg::this_cluster().sync(); }

// The latent widths of the repo's configs: 3 (midi_vqgan_3d_gray), 4 (the
// vqgan recipes), 8 (audio_dac). The wrappers refuse any other D.
#define FUSED_VQ_CASES(X) X(3) X(4) X(8)

// The arguments and the band plan: a cluster of 1, 2, 4 or 8 blocks, bands
// of rows >= 1 rows that cover the image, a power of two of lanes up to 32.
bool tail_args_ok(int B, int H, int W, int Din, int D, int groups, int cluster, int rows,
                  int lanes) {
  return B >= 1 && H >= 1 && W >= 1 && Din >= 1 && D >= 1 && groups >= 1 && D % groups == 0 &&
         (long long)H * W <= 0x7fffffffLL && cluster >= 1 && cluster <= kMaxCluster &&
         (cluster & (cluster - 1)) == 0 && rows >= 1 && (long long)rows * cluster >= H &&
         lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0;
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

namespace {

// K3 for h of type T: the D switch of both entries below.
template <typename T>
int fused_tail_vq(const void* h, long long sb, long long sc, long long sp, int B, int H, int W,
                  int Din, int cluster, int rows, int lanes, const void* w1, const void* b1,
                  const void* gs, const void* gb, const void* cw, const void* cbias,
                  const void* cb, int D, int L, int K, int groups, float eps, void* zq,
                  void* idx, void* stream) {
  if (!tail_args_ok(B, H, W, Din, D, groups, cluster, rows, lanes) || L < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_VQ_K3(N_)                                                                          \
  case N_:                                                                                       \
    return launch_tail<N_, true, T>(                                                             \
        static_cast<const T*>(h), sb, sc, sp, B, H, W, Din, cluster, rows, lanes,                \
        static_cast<const float*>(w1), static_cast<const float*>(b1),                            \
        static_cast<const float*>(gs), static_cast<const float*>(gb),                            \
        static_cast<const float*>(cw), static_cast<const float*>(cbias),                         \
        static_cast<const float*>(cb), L, K, groups, eps, static_cast<T*>(zq),                   \
        static_cast<int*>(idx), nullptr, nullptr, nullptr, s);
  switch (D) {
    FUSED_VQ_CASES(FUSED_VQ_K3)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_VQ_K3
}

}  // namespace

// K3. h (B, H, W, Din) read by the strides sb (image), sc (channel) and sp
// (pixel, p = y*W + x); w1 (D, Din); b1, gs, gb, cbias (D,); cw (D, D, 3, 3)
// OIHW; cb (L, K, D), all fp32; the band plan (cluster, rows, lanes) -> zq
// (B*H*W, D), idx (B*H*W, L) int32. fused_compress_tail_vq takes h and gives
// zq in fp32, fused_compress_tail_vq_bf16 in bf16.
extern "C" int fused_compress_tail_vq(const void* h, long long sb, long long sc, long long sp,
                                      int B, int H, int W, int Din, int cluster, int rows,
                                      int lanes, const void* w1, const void* b1, const void* gs,
                                      const void* gb, const void* cw, const void* cbias,
                                      const void* cb, int D, int L, int K, int groups, float eps,
                                      void* zq, void* idx, void* stream) {
  return fused_tail_vq<float>(h, sb, sc, sp, B, H, W, Din, cluster, rows, lanes, w1, b1, gs, gb,
                              cw, cbias, cb, D, L, K, groups, eps, zq, idx, stream);
}

extern "C" int fused_compress_tail_vq_bf16(const void* h, long long sb, long long sc,
                                           long long sp, int B, int H, int W, int Din,
                                           int cluster, int rows, int lanes, const void* w1,
                                           const void* b1, const void* gs, const void* gb,
                                           const void* cw, const void* cbias, const void* cb,
                                           int D, int L, int K, int groups, float eps, void* zq,
                                           void* idx, void* stream) {
  return fused_tail_vq<__nv_bfloat16>(h, sb, sc, sp, B, H, W, Din, cluster, rows, lanes, w1, b1,
                                      gs, gb, cw, cbias, cb, D, L, K, groups, eps, zq, idx,
                                      stream);
}

// K5. Inputs as K3 without the codebooks -> y1, y2, out, each (B*H*W, D) fp32.
extern "C" int compress_tail_debug(const void* h, long long sb, long long sc, long long sp, int B,
                                   int H, int W, int Din, int cluster, int rows, int lanes,
                                   const void* w1, const void* b1, const void* gs, const void* gb,
                                   const void* cw, const void* cbias, int D, int groups,
                                   float eps, void* y1, void* y2, void* out, void* stream) {
  if (!tail_args_ok(B, H, W, Din, D, groups, cluster, rows, lanes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FUSED_VQ_K5(N_)                                                                         \
  case N_:                                                                                      \
    return launch_tail<N_, false, float>(                                                       \
        static_cast<const float*>(h), sb, sc, sp, B, H, W, Din, cluster, rows, lanes,           \
        static_cast<const float*>(w1), static_cast<const float*>(b1),                           \
        static_cast<const float*>(gs), static_cast<const float*>(gb),                           \
        static_cast<const float*>(cw), static_cast<const float*>(cbias), nullptr, 0, 0, groups, \
        eps, nullptr, nullptr, static_cast<float*>(y1), static_cast<float*>(y2),                \
        static_cast<float*>(out), s);
  switch (D) {
    FUSED_VQ_CASES(FUSED_VQ_K5)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_VQ_K5
}

// The launch floor: empty_cluster_kernel on `blocks` blocks in clusters of
// `cluster` (timed beside K3 by chip_smoke.py). Returns a cudaError_t.
extern "C" int fused_vq_launch_floor(int blocks, int cluster, void* stream) {
  if (blocks < 1 || cluster < 1 || cluster > kMaxCluster || blocks % cluster)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_cluster_kernel);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
