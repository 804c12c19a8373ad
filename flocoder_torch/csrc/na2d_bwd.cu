// 2-D neighborhood attention backward (NATTEN clamped windows) for Hopper.
//
// Replaces the Pallas TPU kernel flocoder_tpu/ops/pallas/na2d.py:
// _na2d_bwd_kernel (entry _bwd -> _na2d_bwd_impl). Same function: given q, k,
// v, the forward output o and the output gradient g, all NHWC (B, H, W, C)
// with C = heads * dh, it returns dq, dk, dv of the clamped ks x ks window
// attention (ks = min(kernel_size, H, W)):
//   P = softmax((q * scale) . k) over each query's window, dP = g . v,
//   delta = rowsum(P * dP) = g . o, dS = P * (dP - delta),
//   dq = scale * dS . K, dk = dS^T . (scale * Q), dv = P^T . g.
//
// What bounds it on an H100: per (pixel, head) it reads q, k, v, o, g and
// writes dq, dk, dv (8 * dh values) against about 10 * ks^2 * dh FLOPs, about
// 15 FLOP/byte in fp32 -- under the card's 67 TFLOP/s / 3.35 TB/s = 20
// FLOP/byte, so it is bound by device memory, in bf16 more so. The design
// reads each input a few times from device memory at most and does the
// window math on the CUDA cores, instead of the TPU kernel's dense masked
// band matmuls (which spend (tile_h+ks-1)*W / ks^2 of their work on masked
// keys and sum overlapping halos with pads):
//
// - Pass 1, query-major (one block per batch*head and 2-D query tile, the K/V
//   halo staged in shared memory as in the forward kernel na2d_fwd.cu): a
//   team of 8 threads per query recomputes the logits of its ks^2 keys with
//   an online softmax and accumulates dq = sum_j P_j (dP_j - delta) k_j in
//   registers, rescaling as the running max moves. delta comes from the
//   saved forward output (g . o), so no pass over dP is needed first. It also
//   writes the query's log-sum-exp and delta (fp32 scratch, one value per
//   pixel and head) for pass 2.
// - Pass 2, key-major (one block per batch*head and 2-D key tile): every key
//   gathers the queries whose clamped windows hold it. Windows are clamped,
//   so near a border a key is seen by more than ks^2 queries (at H = 32,
//   k = 7, key row 6 lies in the windows of query rows 0..9); each key
//   derives its query range from the clamp (q_lo / q_hi below). The block
//   stages scale * q, g, log-sum-exp and delta of the tile's query halo in
//   shared memory; a team of 8 threads per key accumulates dk and dv in
//   registers over its queries. No atomics: every output is written once by
//   one team, so the result is deterministic.
// - fp32 accumulation throughout; outputs are stored in the input dtype.
//   Shared-memory rows are padded to dh + 8 floats as in the forward kernel.
//
// Plain C interface (bound with ctypes); the wrapper
// (flocoder_torch/ops/kernels/na2d.py) validates shapes and dtypes, allocates
// the outputs and the scratch, and raises if the return code is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTeam = 8;        // threads per query (pass 1) or key (pass 2)
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

// Sum over the 8 lanes of a team; ``mask`` names the lanes that take part.
__device__ __forceinline__ float team_sum(float s, unsigned mask) {
  s += __shfl_xor_sync(mask, s, 4);
  s += __shfl_xor_sync(mask, s, 2);
  s += __shfl_xor_sync(mask, s, 1);
  return s;
}

// The queries along one axis of length n whose clamped window
// [clamp(i - ks/2, 0, n - ks), +ks) holds key position j: the contiguous range
// [q_lo(j), q_hi(j)].
__host__ __device__ __forceinline__ int q_lo(int j, int ks) {
  return j <= ks - 1 ? 0 : j - ks + 1 + ks / 2;
}
__host__ __device__ __forceinline__ int q_hi(int j, int n, int ks) {
  return j >= n - ks ? n - 1 : j + ks / 2;
}

// Pass 1: dq, plus the log-sum-exp and delta of every (query, head).
template <typename T, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
na2d_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ g, T* __restrict__ dq,
                   float* __restrict__ lse, float* __restrict__ delta, int H,
                   int W, int heads, int ks, int tile_h, int tile_w, int halo_h,
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
  const int hr0 = min(max(r0 - ks / 2, 0), H - halo_h);
  const int hc0 = min(max(c0 - ks / 2, 0), W - halo_w);

  const size_t img = (size_t)b * H * W;
  const int n_halo = halo_h * halo_w * dh;
  for (int i = threadIdx.x; i < n_halo; i += blockDim.x) {
    const int key = i / dh;
    const int ch = i - key * dh;
    const int kr = key / halo_w;
    const int kc = key - kr * halo_w;
    const size_t gi = (img + (size_t)(hr0 + kr) * W + (hc0 + kc)) * C + hd * dh + ch;
    sk[key * stride + ch] = to_f32(k[gi]);
    sv[key * stride + ch] = to_f32(v[gi]);
  }
  __syncthreads();

  // As in the forward kernel: every team runs the same ks*ks loop so the
  // shuffles stay warp-uniform; teams past the tile or the map redo an
  // in-tile query and do not store.
  const int team = threadIdx.x / kTeam;
  const int lane = threadIdx.x - team * kTeam;
  const bool in_tile = team < tile_h * tile_w;
  const int qr_raw = in_tile ? r0 + team / tile_w : r0;
  const int qc_raw = in_tile ? c0 + team % tile_w : c0;
  const bool live = in_tile && qr_raw < H && qc_raw < W;
  const int qr = min(qr_raw, H - 1);
  const int qc = min(qc_raw, W - 1);
  const size_t pix = img + (size_t)qr * W + qc;
  const size_t qoff = pix * C + hd * dh + lane;

  float qv[CPT];
  float gv[CPT];
  float acc[CPT];
  float dlt = 0.f;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    qv[j] = to_f32(q[qoff + kTeam * j]) * scale;
    gv[j] = to_f32(g[qoff + kTeam * j]);
    dlt = fmaf(gv[j], to_f32(o[qoff + kTeam * j]), dlt);
    acc[j] = 0.f;
  }
  dlt = team_sum(dlt, 0xffffffffu);

  const int rs = min(max(qr - ks / 2, 0), H - ks) - hr0;
  const int cs = min(max(qc - ks / 2, 0), W - ks) - hc0;
  float m = -INFINITY;
  float l = 0.f;
  for (int i = 0; i < ks; ++i) {
    const float* krow = sk + ((rs + i) * halo_w + cs) * stride + lane;
    const float* vrow = sv + ((rs + i) * halo_w + cs) * stride + lane;
    for (int jj = 0; jj < ks; ++jj) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s = fmaf(qv[j], krow[jj * stride + kTeam * j], s);
        dp = fmaf(gv[j], vrow[jj * stride + kTeam * j], dp);
      }
      s = team_sum(s, 0xffffffffu);
      dp = team_sum(dp, 0xffffffffu);
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = fmaf(l, corr, p);
      const float w = p * (dp - dlt);
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] = fmaf(w, krow[jj * stride + kTeam * j], acc[j] * corr);
      m = m_new;
    }
  }
  if (live) {
    const float f = scale / l;
#pragma unroll
    for (int j = 0; j < CPT; ++j) dq[qoff + kTeam * j] = from_f32<T>(acc[j] * f);
    if (lane == 0) {
      lse[pix * heads + hd] = m + logf(l);
      delta[pix * heads + hd] = dlt;
    }
  }
}

// Pass 2: dk and dv, each key gathering the queries that see it.
template <typename T, int CPT>
__global__ void __launch_bounds__(kMaxThreads)
na2d_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int W, int heads, int ks,
                    int tile_h, int tile_w, int tiles_w, int n_tiles,
                    float scale) {
  extern __shared__ float smem[];
  constexpr int dh = CPT * kTeam;
  constexpr int stride = dh + kTeam;
  const int C = heads * dh;

  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int r0 = (tile / tiles_w) * tile_h;
  const int c0 = (tile - (tile / tiles_w) * tiles_w) * tile_w;
  const int r1 = min(r0 + tile_h, H) - 1;
  const int c1 = min(c0 + tile_w, W) - 1;
  // The tile's query halo: the union of its keys' query ranges.
  const int qr0 = q_lo(r0, ks);
  const int qc0 = q_lo(c0, ks);
  const int hh = q_hi(r1, H, ks) - qr0 + 1;
  const int hw = q_hi(c1, W, ks) - qc0 + 1;
  float* sq = smem;                       // scale * q
  float* sg = sq + hh * hw * stride;      // g
  float* sl = sg + hh * hw * stride;      // log-sum-exp
  float* sd = sl + hh * hw;               // delta

  const size_t img = (size_t)b * H * W;
  const int n_halo = hh * hw * dh;
  for (int i = threadIdx.x; i < n_halo; i += blockDim.x) {
    const int p = i / dh;
    const int ch = i - p * dh;
    const int pr = p / hw;
    const int pc = p - pr * hw;
    const size_t gi = (img + (size_t)(qr0 + pr) * W + (qc0 + pc)) * C + hd * dh + ch;
    sq[p * stride + ch] = to_f32(q[gi]) * scale;
    sg[p * stride + ch] = to_f32(g[gi]);
  }
  for (int p = threadIdx.x; p < hh * hw; p += blockDim.x) {
    const int pr = p / hw;
    const int pc = p - pr * hw;
    const size_t gi = (img + (size_t)(qr0 + pr) * W + (qc0 + pc)) * heads + hd;
    sl[p] = lse[gi];
    sd[p] = delta[gi];
  }
  __syncthreads();

  // Teams past the tile redo key (r0, c0); teams past the map's ragged edge
  // redo the last row/column, which lies in this tile. Neither stores. Each
  // team loops over its own key's queries, so the shuffles name only the
  // team's 8 lanes.
  const int team = threadIdx.x / kTeam;
  const int lane = threadIdx.x - team * kTeam;
  const unsigned mask = 0xffu << (kTeam * (team & 3));
  const bool in_tile = team < tile_h * tile_w;
  const int kr_raw = in_tile ? r0 + team / tile_w : r0;
  const int kc_raw = in_tile ? c0 + team % tile_w : c0;
  const bool live = in_tile && kr_raw < H && kc_raw < W;
  const int kr = min(kr_raw, H - 1);
  const int kc = min(kc_raw, W - 1);
  const size_t koff = (img + (size_t)kr * W + kc) * C + hd * dh + lane;

  float kv[CPT];
  float vv[CPT];
  float dka[CPT];
  float dva[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    kv[j] = to_f32(k[koff + kTeam * j]);
    vv[j] = to_f32(v[koff + kTeam * j]);
    dka[j] = 0.f;
    dva[j] = 0.f;
  }

  const int a0 = q_lo(kr, ks) - qr0;
  const int a1 = q_hi(kr, H, ks) - qr0;
  const int b0 = q_lo(kc, ks) - qc0;
  const int b1 = q_hi(kc, W, ks) - qc0;
  for (int a = a0; a <= a1; ++a) {
    for (int bb = b0; bb <= b1; ++bb) {
      const int p = a * hw + bb;
      const float* qrow = sq + p * stride + lane;
      const float* grow = sg + p * stride + lane;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        s = fmaf(qrow[kTeam * j], kv[j], s);
        dp = fmaf(grow[kTeam * j], vv[j], dp);
      }
      s = team_sum(s, mask);
      dp = team_sum(dp, mask);
      const float pr = expf(s - sl[p]);
      const float ds = pr * (dp - sd[p]);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        dka[j] = fmaf(ds, qrow[kTeam * j], dka[j]);
        dva[j] = fmaf(pr, grow[kTeam * j], dva[j]);
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      dk[koff + kTeam * j] = from_f32<T>(dka[j]);
      dv[koff + kTeam * j] = from_f32<T>(dva[j]);
    }
  }
}

// Largest query-halo extent along one axis over the key tiles of size t.
int max_query_span(int n, int t, int ks) {
  int best = 0;
  for (int r0 = 0; r0 < n; r0 += t) {
    const int r1 = min(r0 + t, n) - 1;
    best = max(best, q_hi(r1, n, ks) - q_lo(r0, ks) + 1);
  }
  return best;
}

// Shared memory of one pass-2 block for key tiles of t_h x t_w: scale * q and
// g of the widest query halo (rows padded to dh + 8 floats), then its
// log-sum-exp and delta.
size_t dkv_smem_bytes(int H, int W, int dh, int ks, int t_h, int t_w) {
  const size_t n = (size_t)max_query_span(H, t_h, ks) * max_query_span(W, t_w, ks);
  return (2 * n * (dh + kTeam) + 2 * n) * sizeof(float);
}

// Key tile of pass 2: the least staging over the whole map (each staged query
// a read of 2 * dh values), counting a padded entry of a ragged tile as ks^2
// staged pixels, among the tiles that fit one block's shared memory; ties go
// to the larger, then the wider tile. A key near a border is seen by up to
// (ks + ks/2)^2 queries, so at dh 128 only a 1x1 key tile would leave room
// for two blocks per SM: key tiles take the one-block budget. Returns false
// when no tile fits.
bool pick_key_tile(int H, int W, int dh, int ks, int* tile_h, int* tile_w) {
  constexpr size_t kSmemBudget = 227 * 1024;
  constexpr int kMaxKeys = kMaxThreads / kTeam;
  long long best = -1;
  for (int th = 1; th <= min(H, kMaxKeys); ++th) {
    for (int tw = 1; tw <= min(W, kMaxKeys / th); ++tw) {
      if (dkv_smem_bytes(H, W, dh, ks, th, tw) > kSmemBudget) continue;
      const long long n_tiles = (long long)((H + th - 1) / th) * ((W + tw - 1) / tw);
      const long long staged =
          n_tiles * max_query_span(H, th, ks) * max_query_span(W, tw, ks);
      const long long padded = n_tiles * th * tw - (long long)H * W;
      const long long cost = staged + padded * ks * ks;
      const int area = th * tw;
      const int best_area = *tile_h * *tile_w;
      if (best < 0 || cost < best ||
          (cost == best && (area > best_area || (area == best_area && tw > *tile_w)))) {
        best = cost;
        *tile_h = th;
        *tile_w = tw;
      }
    }
  }
  return best >= 0;
}

template <typename T, int CPT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* g, void* dq, void* dk, void* dv, float* lse,
                   float* delta, int B, int H, int W, int heads, int ks,
                   int tile_h, int tile_w, float scale, cudaStream_t stream) {
  constexpr int dh = CPT * kTeam;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);

  // pass 1: query tiles, K/V halo
  const int halo_h = min(tile_h + ks - 1, H);
  const int halo_w = min(tile_w + ks - 1, W);
  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int n_tiles = ((H + tile_h - 1) / tile_h) * tiles_w;
  const size_t smem1 = 2u * halo_h * halo_w * (dh + kTeam) * sizeof(float);
  const int threads1 = ((tile_h * tile_w * kTeam + 31) / 32) * 32;
  const long long blocks1 = (long long)B * heads * n_tiles;
  // pass 2: key tiles, query halo
  int ktile_h = 0, ktile_w = 0;
  if (!pick_key_tile(H, W, dh, ks, &ktile_h, &ktile_w)) return cudaErrorInvalidConfiguration;
  const int ktiles_w = (W + ktile_w - 1) / ktile_w;
  const int kn_tiles = ((H + ktile_h - 1) / ktile_h) * ktiles_w;
  const size_t smem2 = dkv_smem_bytes(H, W, dh, ks, ktile_h, ktile_w);
  const int threads2 = ((ktile_h * ktile_w * kTeam + 31) / 32) * 32;
  const long long blocks2 = (long long)B * heads * kn_tiles;
  if (threads1 > kMaxThreads || threads2 > kMaxThreads || blocks1 > 0x7fffffffLL ||
      blocks2 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;

  cudaError_t err = cudaFuncSetAttribute(na2d_bwd_dq_kernel<T, CPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(na2d_bwd_dkv_kernel<T, CPT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;

  na2d_bwd_dq_kernel<T, CPT><<<(unsigned)blocks1, threads1, smem1, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tg, static_cast<T*>(dq), lse, delta, H, W,
      heads, ks, tile_h, tile_w, halo_h, halo_w, tiles_w, n_tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  na2d_bwd_dkv_kernel<T, CPT><<<(unsigned)blocks2, threads2, smem2, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, W, heads,
      ks, ktile_h, ktile_w, ktiles_w, kn_tiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int cpt, const void* q, const void* k, const void* v,
                     const void* o, const void* g, void* dq, void* dk, void* dv,
                     float* lse, float* delta, int B, int H, int W, int heads,
                     int ks, int tile_h, int tile_w, float scale, cudaStream_t s) {
#define NA2D_CASE(N)                                                                 \
  case N:                                                                            \
    return launch<T, N>(q, k, v, o, g, dq, dk, dv, lse, delta, B, H, W, heads, ks,   \
                        tile_h, tile_w, scale, s);
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
// (tile_h, tile_w): query tile of pass 1 (the forward kernel's); pass 2 picks
// its own key tile (pick_key_tile). lse and delta: fp32 scratch of
// B*H*W*heads values each. Returns a cudaError_t (0 = both passes launched).
extern "C" int na2d_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* g, void* dq, void* dk, void* dv, void* lse,
                        void* delta, int dtype, int B, int H, int W, int heads,
                        int dh, int ks, int tile_h, int tile_w, float scale,
                        void* stream) {
  if (dh % kTeam != 0 || dh < kTeam || dh > 16 * kTeam || ks < 1 || ks > H ||
      ks > W || tile_h < 1 || tile_w < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cpt = dh / kTeam;
  float* fl = static_cast<float*>(lse);
  float* fd = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)dispatch<float>(cpt, q, k, v, o, g, dq, dk, dv, fl, fd, B, H, W, heads,
                                ks, tile_h, tile_w, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(cpt, q, k, v, o, g, dq, dk, dv, fl, fd, B, H, W,
                                        heads, ks, tile_h, tile_w, scale, s);
  return (int)cudaErrorInvalidValue;
}
