// 2-D neighborhood attention forward (NATTEN clamped windows) on Hopper's
// tensor cores.
//
// Replaces the Pallas TPU kernel flocoder_tpu/ops/pallas/na2d.py:_na2d_kernel
// (entry na2d_pallas -> _na2d_fwd_impl). Same function: q, k, v are NHWC
// (B, H, W, C) with C = heads * dh; every query attends to exactly ks x ks
// keys (ks = min(kernel_size, H, W)), windows slide inward at the borders;
// logits are scale * (q . k), the softmax is taken in fp32.
//
// What bounds it on an H100: q, k, v read once and the output written once
// is 4 * dh * sizeof(T) bytes per (pixel, head) against 4 * ks^2 * dh FLOPs;
// the tensor cores do that work well under the byte time, so the bound is
// device memory. What held the CUDA-core version back was shared-memory
// traffic and issue (every K/V row read again by each of up to 49 queries,
// a shuffle sum and two exps per query-key pair). This design:
//
// - One block per (batch * head, 2-D query tile), 1 to 8 warps. The tile's
//   K/V halo ((tile_h + ks - 1) x (tile_w + ks - 1) pixels clamped into the
//   map) is staged in shared memory in the input dtype with 16-byte
//   cp.async copies. With two_buf both halos are resident and V's copy
//   overlaps the logits; otherwise V follows K through one buffer. The plan
//   (tile, halo, buffers, shared bytes) comes from the host
//   (flocoder_torch/ops/kernels/na2d.py:plan_queries).
// - One warp owns a 4 x 4 patch of queries, the M = 16 rows of mma.sync.
//   The union of their clamped windows is at most (3 + ks)^2 = 100 keys
//   (clamping moves windows only inward), padded to whole n8 tiles. The
//   warp computes S = Q.K^T over the union into registers (fp32 inputs:
//   m16n8k8 TF32 with the 3xTF32 split; bf16: m16n8k16), masks keys outside
//   each query's window to -inf, takes the exact softmax in registers (row
//   max and sum over the 4 lanes of a row), then O = P.V by mma.sync (P cast
//   to bf16 for bf16 inputs, as the TPU kernel does) and divides by the sum.
//   Each K/V fragment a warp reads from shared memory now serves 16 queries.
//   The queries' own rows (the A operand) are read from device memory once
//   per k step: staging them too took shared memory and so blocks per SM,
//   and timed slower on the card.
// - Two blocks of up to 8 warps share an SM (__launch_bounds__(256, 2), at
//   most 128 registers a thread); what limits the kernel on the card is in
//   PERF.md.
//
// Plain C interface (bound with ctypes); the wrapper validates shapes,
// dtypes and alignment, allocates the output, and raises if the return code
// is not 0.

#include "na2d_mma.cuh"

namespace {

using namespace na2d;

template <typename T, int DHMAX>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
na2d_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, int H, int W, int heads, int dh, int ks, int tile_h,
                int tile_w, int halo_h, int halo_w, int two_buf, int table, float scale_log2) {
  using O = Op<T>;
  constexpr int NT = kUnionTiles;
  constexpr int NG = NT / O::NG;                 // B-operand groups of the union
  constexpr int NDT = DHMAX / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int srow = O::srow(dh);
  const int halo_px = halo_h * halo_w;
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = two_buf ? sk + halo_px * srow : sk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int2* tab = reinterpret_cast<int2*>(sk + (1 + two_buf) * halo_px * srow) + warp * table;

  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int n_tiles = ((H + tile_h - 1) / tile_h) * tiles_w;
  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int r0 = (tile / tiles_w) * tile_h;
  const int c0 = (tile % tiles_w) * tile_w;
  const int hr0 = min(max(r0 - ks / 2, 0), H - halo_h);
  const int hc0 = min(max(c0 - ks / 2, 0), W - halo_w);
  const int C = heads * dh;
  const size_t base = (size_t)b * H * W * C + (size_t)hd * dh;

  stage(sk, k + base, hr0, hc0, halo_h, halo_w, W, C, dh, srow);
  cp_async_commit();
  if (two_buf) {
    stage(sv, v + base, hr0, hc0, halo_h, halo_w, W, C, dh, srow);
    cp_async_commit();
  }

  // The warp's patch, its rows g and g + 8 (clamped into the map; rows past
  // the map's ragged edge compute a valid query and do not store), and the
  // union of their windows.
  const int pw = tile_w / kPatch;
  const int pr0 = r0 + (warp / pw) * kPatch;
  const int pc0 = c0 + (warp % pw) * kPatch;
  const bool live_patch = pr0 < H && pc0 < W;
  const int ra = pr0 + g / 4, rb = ra + 2, cq = pc0 + g % 4;
  const bool live_a = ra < H && cq < W, live_b = rb < H && cq < W;
  const int qra = min(ra, H - 1), qrb = min(rb, H - 1), qc = min(cq, W - 1);
  const int ur0 = window_start(min(pr0, H - 1), H, ks);
  const int uc0 = window_start(min(pc0, W - 1), W, ks);
  const int ubh = window_start(min(pr0 + kPatch - 1, H - 1), H, ks) - ur0 + ks;
  const int ubw = window_start(min(pc0 + kPatch - 1, W - 1), W, ks) - uc0 + ks;
  const int nu = ubh * ubw;
  const int nt = (nu + O::KS - 1) / O::KS * (O::KS / 8);   // n8 tiles, whole k steps
  const int wra = window_start(qra, H, ks) - ur0, wrb = window_start(qrb, H, ks) - ur0;
  const int wc = window_start(qc, W, ks) - uc0;

  // Key table: shared offset and (row << 8 | col) in the union; padding
  // entries point at key 0 and fall outside every window.
  for (int n = lane; n < table; n += 32) {
    int2 e = make_int2(0, 0xffff);
    if (n < nu) {
      const int kr = n / ubw, kc = n - (n / ubw) * ubw;
      e = make_int2(((ur0 - hr0 + kr) * halo_w + uc0 - hc0 + kc) * srow, (kr << 8) | kc);
    }
    tab[n] = e;
  }
  __syncwarp();

  if (two_buf) cp_async_wait<1>(); else cp_async_wait<0>();
  __syncthreads();

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  float la = 0.f, lb = 0.f;
  if (live_patch) {
    typename O::Cols kc[NG];
#pragma unroll
    for (int jg = 0; jg < NG; ++jg)
      if (jg * O::NG < nt) kc[jg] = O::cols(tab, jg, 1, lane, nt);
    const T* qa = q + base + ((size_t)qra * W + qc) * C;
    const T* qb = q + base + ((size_t)qrb * W + qc) * C;
#pragma unroll 1
    for (int k0 = 0; k0 < dh; k0 += O::KS) {
      const typename O::A a = O::a_rows(qa, qb, k0, dh, t);
#pragma unroll
      for (int jg = 0; jg < NG; ++jg)
        if (jg * O::NG < nt) O::mma_cols(s, jg, a, sk, kc[jg], k0, t, nt);
    }
    // Mask, scale (to log2 units) and the exact softmax of rows g and g + 8.
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = j < nt ? tab[8 * j + 2 * t + e].y : 0xffff;
        const int kr = pos >> 8, kcol = pos & 0xff;
        const bool col = (unsigned)(kcol - wc) < (unsigned)ks;
        s[j][e] = col && (unsigned)(kr - wra) < (unsigned)ks ? s[j][e] * scale_log2 : -INFINITY;
        s[j][2 + e] =
            col && (unsigned)(kr - wrb) < (unsigned)ks ? s[j][2 + e] * scale_log2 : -INFINITY;
        ma = fmaxf(ma, s[j][e]);
        mb = fmaxf(mb, s[j][2 + e]);
      }
    }
    ma = warp_max4(ma);
    mb = warp_max4(mb);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - ma);
        s[j][2 + e] = exp2f(s[j][2 + e] - mb);
        la += s[j][e];
        lb += s[j][2 + e];
      }
    }
    la = warp_sum4(la);
    lb = warp_sum4(lb);
  }

  if (!two_buf) {             // V takes K's buffer once every warp is done with K
    __syncthreads();
    stage(sv, v + base, hr0, hc0, halo_h, halo_w, W, C, dh, srow);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!live_patch) return;

  float o[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NT * 8 / O::KS; ++kk) {
    if (kk * O::KS < nt * 8)
      O::mma_rows(o, O::a_acc(s, kk), sv, O::rows(tab + kk * O::KS, 1, lane), dh, g);
  }
  const float ia = 1.f / la, ib = 1.f / lb;
  T* oa = out + base + ((size_t)qra * W + qc) * C + 2 * t;
  T* ob = out + base + ((size_t)qrb * W + qc) * C + 2 * t;
#pragma unroll
  for (int n = 0; n < NDT; ++n) {
    if (n * 8 < dh) {
      if (live_a) O::store2(oa + n * 8, o[n][0] * ia, o[n][1] * ia);
      if (live_b) O::store2(ob + n * 8, o[n][2] * ib, o[n][3] * ib);
    }
  }
}

template <typename T, int DHMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H,
                   int W, int heads, int dh, int ks, int tile_h, int tile_w, int halo_h,
                   int halo_w, int two_buf, int smem, float scale, cudaStream_t stream) {
  using O = Op<T>;
  const int warps = (tile_h / kPatch) * (tile_w / kPatch);
  const int table = ((ks + kPatch - 1) * (ks + kPatch - 1) + O::KS - 1) / O::KS * O::KS;
  const size_t need =
      (size_t)(1 + two_buf) * halo_h * halo_w * O::srow(dh) * sizeof(T) +
      (size_t)warps * table * sizeof(int2);
  const long long blocks = (long long)B * heads * ((H + tile_h - 1) / tile_h) *
                           ((W + tile_w - 1) / tile_w);
  if (need > (size_t)smem || blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(na2d_fwd_kernel<T, DHMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  na2d_fwd_kernel<T, DHMAX><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, W, heads, dh, ks, tile_h, tile_w, halo_h, halo_w, two_buf, table,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int B, int H,
                     int W, int heads, int dh, int ks, int tile_h, int tile_w, int halo_h,
                     int halo_w, int two_buf, int smem, float scale, cudaStream_t s) {
#define NA2D_CASE(N)                                                                   \
  case N:                                                                              \
    return launch<T, N>(q, k, v, out, B, H, W, heads, dh, ks, tile_h, tile_w, halo_h,  \
                        halo_w, two_buf, smem, scale, s);
  switch (dh_bucket(dh)) {
    NA2D_CASE(16) NA2D_CASE(32) NA2D_CASE(64) NA2D_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef NA2D_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dh a multiple of 8 up to 128; ks up to 7.
// (tile_h, tile_w, halo_h, halo_w, two_buf, smem): the host's launch plan;
// the entry checks that it is consistent and that its layout fits ``smem``
// bytes. Returns a cudaError_t (0 = launched).
extern "C" int na2d_fwd(const void* q, const void* k, const void* v, void* out, int dtype,
                        int B, int H, int W, int heads, int dh, int ks, int tile_h, int tile_w,
                        int halo_h, int halo_w, int two_buf, int smem, float scale,
                        void* stream) {
  if (dh % 8 != 0 || dh < 8 || dh > 128 || ks < 1 || ks > kKsMax || ks > H || ks > W ||
      tile_h < kPatch || tile_w < kPatch || tile_h % kPatch || tile_w % kPatch ||
      (tile_h / kPatch) * (tile_w / kPatch) > kMaxWarps || halo_h != min(tile_h + ks - 1, H) ||
      halo_w != min(tile_w + ks - 1, W) || (two_buf != 0 && two_buf != 1) || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, out, B, H, W, heads, dh, ks, tile_h, tile_w, halo_h,
                                halo_w, two_buf, smem, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, B, H, W, heads, dh, ks, tile_h, tile_w,
                                        halo_h, halo_w, two_buf, smem, scale, s);
  return (int)cudaErrorInvalidValue;
}
