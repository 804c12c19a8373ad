// Shared pieces of the NA2D kernels K1 (na2d_fwd.cu) and K2 (na2d_bwd.cu):
// the window geometry, 16-byte cp.async staging, and the mma.sync fragments
// of Hopper's tensor cores for fp32 (3xTF32) and bf16 inputs.
//
// Fragment layouts (PTX ISA, mma.sync m16n8k8 .tf32 and m16n8k16 .bf16), for
// lane = 4 * g + t:
// - the accumulator C (16 x 8, fp32): c0 = (row g, col 2t), c1 = (g, 2t+1),
//   c2 = (g+8, 2t), c3 = (g+8, 2t+1);
// - A (16 x 8 tf32): a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4), a3 = (g+8, t+4);
//   A (16 x 16 bf16, two values a register): (g, 2t..2t+1), (g+8, 2t..),
//   (g, 2t+8..), (g+8, 2t+8..);
// - B (8 x 8 tf32): b0 = (k t, col g), b1 = (k t+4, col g);
//   B (16 x 8 bf16): (k 2t..2t+1, col g), (k 2t+8..2t+9, col g).
//
// The k order of a product is free as long as A and B agree. In TF32 it
// serves two ends: over channels, k = t and t+4 stand for channels 2t and
// 2t+1, so a lane loads its two values with one 8-byte load; over keys, when
// the A operand is an accumulator of the previous product (P.V after Q.K^T,
// dS.K after dP), k = t and t+4 stand for the accumulator's columns 2t and
// 2t+1, so P needs no shuffle. In bf16 two n8 accumulator tiles make one k16
// A tile, as in FlashAttention-2, and ldmatrix loads the B operands.
//
// fp32 inputs take the 3xTF32 split: x = hi + lo with hi = cvt.rna.tf32(x)
// and lo = x - hi (the tensor core reads lo's top 10 mantissa bits), and
// a.b ~ lo.hi' + hi.lo' + hi.hi', about fp32's accuracy. A single TF32
// product (relative error ~5e-4) would miss the kernels' 1e-4 gates.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace na2d {

constexpr int kPatch = 4;      // a warp owns a 4 x 4 patch: the 16 rows of an mma tile
constexpr int kMaxWarps = 8;
constexpr int kKsMax = 7;      // (3 + 7)^2 = 100 keys of a patch's union <= 14 n8 tiles
constexpr int kUnionTiles = 14;
constexpr int kSmemMax = 227 * 1024;

// First row (or column) of the clamped window of query i on an axis of n.
__host__ __device__ __forceinline__ int window_start(int i, int n, int ks) {
  return min(max(i - ks / 2, 0), n - ks);
}
// The queries on an axis of n whose clamped windows hold key j: [q_lo, q_hi].
__host__ __device__ __forceinline__ int q_lo(int j, int ks) {
  return j <= ks - 1 ? 0 : j - ks + 1 + ks / 2;
}
__host__ __device__ __forceinline__ int q_hi(int j, int n, int ks) {
  return j >= n - ks ? n - 1 : j + ks / 2;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max4(float x) {   // over the 4 lanes of a row
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float warp_sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T>
struct Op;

// fp32 inputs: m16n8k8 TF32 with the 3xTF32 split.
template <>
struct Op<float> {
  static constexpr int KS = 8;   // k of one mma
  struct A { uint32_t hi[4], lo[4]; };
  struct B { uint32_t hi[2], lo[2]; };

  // Shared-memory row stride in elements: dh + 4 floats, an odd multiple of
  // 16 bytes, so the 8 rows x 4 columns of a fragment hit 32 banks.
  __host__ __device__ static int srow(int dh) { return dh + 4; }

  __device__ static void split(float x, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
  // A from two row pointers (rows g and g+8, in device memory) over
  // channels k0..k0+7; k = t stands for channel k0 + 2t and k = t+4 for
  // k0 + 2t + 1 (mma_cols reads B in the same order), so each lane loads
  // two neighbours at once.
  __device__ static A a_rows(const float* r0, const float* r1, int k0, int dh, int t) {
    A a;
    const float2 x0 = *reinterpret_cast<const float2*>(r0 + k0 + 2 * t);
    const float2 x1 = *reinterpret_cast<const float2*>(r1 + k0 + 2 * t);
    split(x0.x, a.hi[0], a.lo[0]);
    split(x1.x, a.hi[1], a.lo[1]);
    split(x0.y, a.hi[2], a.lo[2]);
    split(x1.y, a.hi[3], a.lo[3]);
    return a;
  }
  // A from the accumulator tile kk (see the header on the k order).
  template <int N>
  __device__ static A a_acc(const float (&s)[N][4], int kk) {
    A a;
    split(s[kk][0], a.hi[0], a.lo[0]);
    split(s[kk][2], a.hi[1], a.lo[1]);
    split(s[kk][1], a.hi[2], a.lo[2]);
    split(s[kk][3], a.hi[3], a.lo[3]);
    return a;
  }

  // Products over channels, B[k][n] = row_n[k0 + k] for the n8 tiles of a
  // key (or query) table (``tab``: shared offsets in units of ``mult``
  // elements): a group is two tiles, a lane reads the rows of n = g. The
  // three products of the split (small terms first: lo.hi', hi.lo',
  // hi.hi') are interleaved over the group, so that no mma waits on the one
  // just issued.
  static constexpr int NG = 2;
  struct Cols { int o[2]; };
  __device__ static Cols cols(const int2* tab, int jg, int mult, int lane, int nt) {
    Cols c;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      c.o[i] = 2 * jg + i < nt ? tab[8 * (2 * jg + i) + (lane >> 2)].x * mult : 0;
    return c;
  }
  template <int N>
  __device__ static void mma_cols(float (&c)[N][4], int jg, const A& a, const float* base,
                                  const Cols& col, int k0, int t, int nt) {
    B b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 x = *reinterpret_cast<const float2*>(base + col.o[i] + k0 + 2 * t);
      split(x.x, b[i].hi[0], b[i].lo[0]);
      split(x.y, b[i].hi[1], b[i].lo[1]);
    }
    const bool two = 2 * jg + 1 < nt;
    mma1(c[2 * jg], a.lo, b[0].hi);
    if (two) mma1(c[2 * jg + 1], a.lo, b[1].hi);
    mma1(c[2 * jg], a.hi, b[0].lo);
    if (two) mma1(c[2 * jg + 1], a.hi, b[1].lo);
    mma1(c[2 * jg], a.hi, b[0].hi);
    if (two) mma1(c[2 * jg + 1], a.hi, b[1].hi);
  }

  // Products over keys (or queries), B[k][n] = row_k[n] for the column
  // tiles of dh: k = t and t+4 name the table's rows 2t and 2t+1 of the k
  // step that starts at ``tab``, the accumulator's columns (a_acc). Groups
  // of up to four column tiles interleave their products.
  struct Rows { int o0, o1; };
  __device__ static Rows rows(const int2* tab, int mult, int lane) {
    const int t = lane & 3;
    return {tab[2 * t].x * mult, tab[2 * t + 1].x * mult};
  }
  template <int NDT>
  __device__ static void mma_rows(float (&c)[NDT][4], const A& a, const float* base,
                                  const Rows& r, int dh, int g) {
    constexpr int GS = NDT < 4 ? NDT : 4;
#pragma unroll
    for (int n0 = 0; n0 < NDT; n0 += GS) {
      if (n0 * 8 >= dh) break;
      B b[GS];
#pragma unroll
      for (int i = 0; i < GS; ++i) {
        const int ch = (n0 + i) * 8 < dh ? (n0 + i) * 8 + g : g;
        split(base[r.o0 + ch], b[i].hi[0], b[i].lo[0]);
        split(base[r.o1 + ch], b[i].hi[1], b[i].lo[1]);
      }
#pragma unroll
      for (int i = 0; i < GS; ++i)
        if ((n0 + i) * 8 < dh) mma1(c[n0 + i], a.lo, b[i].hi);
#pragma unroll
      for (int i = 0; i < GS; ++i)
        if ((n0 + i) * 8 < dh) mma1(c[n0 + i], a.hi, b[i].lo);
#pragma unroll
      for (int i = 0; i < GS; ++i)
        if ((n0 + i) * 8 < dh) mma1(c[n0 + i], a.hi, b[i].hi);
    }
  }

  __device__ static void mma1(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  __device__ static void store2(float* p, float x, float y) {
    *reinterpret_cast<float2*>(p) = make_float2(x, y);
  }
  __device__ static float load(const float* p) { return *p; }
};

// bf16 inputs: m16n8k16 bf16 with fp32 accumulation.
template <>
struct Op<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int KS = 16;
  struct A { uint32_t r[4]; };
  struct B { uint32_t r[2]; };

  // dh padded to a multiple of 16 (zeros in the pad), then 8 more values:
  // an odd multiple of 16 bytes.
  __host__ __device__ static int srow(int dh) { return (dh + 15) / 16 * 16 + 8; }

  __device__ static uint32_t pack(float x, float y) {
    __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static uint32_t pair(const T* p) { return *reinterpret_cast<const uint32_t*>(p); }
  // A from two row pointers (rows g and g+8, in device memory); columns
  // past dh (dh a multiple of 8, not of 16) read as zeros.
  __device__ static A a_rows(const T* r0, const T* r1, int k0, int dh, int t) {
    A a;
    const int c0 = k0 + 2 * t, c1 = c0 + 8;
    a.r[0] = c0 < dh ? pair(r0 + c0) : 0u;
    a.r[1] = c0 < dh ? pair(r1 + c0) : 0u;
    a.r[2] = c1 < dh ? pair(r0 + c1) : 0u;
    a.r[3] = c1 < dh ? pair(r1 + c1) : 0u;
    return a;
  }
  // A from the accumulator tiles 2kk and 2kk+1.
  template <int N>
  __device__ static A a_acc(const float (&s)[N][4], int kk) {
    A a;
    a.r[0] = pack(s[2 * kk][0], s[2 * kk][1]);
    a.r[1] = pack(s[2 * kk][2], s[2 * kk][3]);
    a.r[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a.r[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    return a;
  }

  __device__ static void ldsm_x4(uint32_t (&d)[4], const T* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(s));
  }
  __device__ static void ldsm_x4_trans(uint32_t (&d)[4], const T* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
                 : "r"(s));
  }
  __device__ static void ldsm_x2_trans(uint32_t (&d)[2], const T* p) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(d[0]), "=r"(d[1])
                 : "r"(s));
  }

  // Products over channels: a group is two n8 tiles, loaded by one
  // ldmatrix.x4 whose four 8 x 8 matrices are (tile 2jg, channels k0..k0+7),
  // (2jg, k0+8..), (2jg+1, k0..), (2jg+1, k0+8..); lane i gives the row of
  // matrix i / 8.
  static constexpr int NG = 2;
  struct Cols { int o; };
  __device__ static Cols cols(const int2* tab, int jg, int mult, int lane, int nt) {
    return {tab[16 * jg + 8 * (lane >> 4) + (lane & 7)].x * mult + 8 * ((lane >> 3) & 1)};
  }
  template <int N>
  __device__ static void mma_cols(float (&c)[N][4], int jg, const A& a, const T* base,
                                  const Cols& col, int k0, int t, int nt) {
    uint32_t d[4];
    ldsm_x4(d, base + col.o + k0);
    mma(c[2 * jg], a, B{{d[0], d[1]}});
    mma(c[2 * jg + 1], a, B{{d[2], d[3]}});
  }

  // Products over keys (or queries): ldmatrix.trans of the k step's 16
  // table rows, two column tiles of dh at a time (matrices (rows 0..7,
  // tile n), (rows 8..15, n), (0..7, n+1), (8..15, n+1)); an odd last tile
  // takes x2, whose addresses come from lanes 0..15.
  struct Rows { int o; };
  __device__ static Rows rows(const int2* tab, int mult, int lane) {
    return {tab[(lane & 7) + 8 * ((lane >> 3) & 1)].x * mult + 8 * (lane >> 4)};
  }
  template <int NDT>
  __device__ static void mma_rows(float (&c)[NDT][4], const A& a, const T* base, const Rows& r,
                                  int dh, int g) {
#pragma unroll
    for (int n = 0; n < NDT; n += 2) {
      if (n * 8 + 8 < dh) {
        uint32_t d[4];
        ldsm_x4_trans(d, base + r.o + n * 8);
        mma(c[n], a, B{{d[0], d[1]}});
        mma(c[n + 1], a, B{{d[2], d[3]}});
      } else if (n * 8 < dh) {
        uint32_t d[2];
        ldsm_x2_trans(d, base + r.o + n * 8);
        mma(c[n], a, B{{d[0], d[1]}});
      }
    }
  }

  __device__ static void mma(float (&c)[4], const A& a, const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]), "r"(b.r[1]));
  }
  __device__ static void store2(T* p, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  }
  __device__ static float load(const T* p) { return __bfloat162float(*p); }
};

// Stages the head slice (dh values at ``src + pixel * C``) of a rows x cols
// box of pixels starting at (r0, c0) into shared rows of ``srow`` elements,
// with 16-byte cp.async copies (dh * sizeof(T) is a multiple of 16); in bf16
// the pad up to the next multiple of 16 values is zeroed. The caller
// commits and waits.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int r0, int c0, int rows, int cols,
                                      int W, int C, int dh, int srow) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = dh / kVec;
  const int n = rows * cols * chunks;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int px = i / chunks;
    const int ch = i - px * chunks;
    const int r = px / cols;
    const int c = px - r * cols;
    cp_async16(dst + px * srow + ch * kVec,
               src + ((size_t)(r0 + r) * W + (c0 + c)) * C + ch * kVec);
  }
  if (sizeof(T) == 2 && dh % 16) {
    for (int px = threadIdx.x; px < rows * cols; px += blockDim.x)
      *reinterpret_cast<uint4*>(dst + px * srow + dh) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// Smallest dh bucket (16, 32, 64, 128) that holds dh; the kernels are
// instantiated per bucket and loop over dh / 8 column tiles at run time.
inline int dh_bucket(int dh) { return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : 128; }

}  // namespace na2d
