// 2-D neighborhood attention backward (NATTEN clamped windows) on Hopper's
// tensor cores.
//
// Replaces the Pallas TPU kernel flocoder_tpu/ops/pallas/na2d.py:
// _na2d_bwd_kernel (entry _bwd -> _na2d_bwd_impl). Same function: given q, k,
// v, the forward output o and the output gradient g, all NHWC (B, H, W, C)
// with C = heads * dh, it returns dq, dk, dv of the clamped ks x ks window
// attention (ks = min(kernel_size, H, W)):
//   P = softmax(scale * q . k) over each query's window, dP = g . v,
//   delta = rowsum(P * dP) = g . o, dS = P * (dP - delta),
//   dq = scale * dS . K, dk = scale * dS^T . Q, dv = P^T . g.
//
// What bounds it on an H100: it reads q, k, v, o, g and writes dq, dk, dv
// (8 * dh * sizeof(T) bytes per pixel and head) against about 10 * ks^2 * dh
// FLOPs; on the tensor cores that work fits under the byte time, so the
// bound is device memory. Two passes keep it deterministic: no atomics,
// every output written once. Both use the warp tiling and the fragments of
// the forward kernel (na2d_fwd.cu, na2d_mma.cuh):
//
// - Pass 1, query-major (one block per batch * head and query tile, one warp
//   per 4 x 4 query patch, the K/V halo staged by cp.async in the input
//   dtype): dP = G.V^T over the patch's key union, then S = Q.K^T and its
//   exact softmax in registers (P and the log-sum-exp), dS = P * (dP -
//   delta) with delta = g . o, and dQ = scale * dS.K. V is staged first, so
//   that with one buffer K can follow it once dP is done. It writes dq, the
//   log-sum-exp and delta (fp32 scratch, one value per pixel and head).
// - Pass 2, key-major (one block per batch * head and key tile, one warp per
//   4 x 4 key patch): the queries whose clamped windows hold the patch's keys
//   come from q_lo / q_hi; near a border the range is wider than ks. The
//   block stages q, g, log-sum-exp and delta of the tile's query halo; each
//   warp walks its patch's query union in chunks: S^T = K.Q^T, P^T =
//   exp(scale * S^T - lse) masked to the window relation, dP^T = V.G^T,
//   dS^T = P^T * (dP^T - delta), dK += dS^T.Q, dV += P^T.G, and writes dk
//   (times scale) and dv once.
// - A head wider than 128 (dh 256) runs the products into dq, dk and dv in
//   two 128-column slices, the scores still over the whole dh: pass 1
//   feeds both slices of dQ from the same registers of dS; pass 2 walks
//   its query union once per slice, recomputing S^T and dP^T. So the
//   accumulators take the registers they take at dh 128.
// - fp32 inputs take m16n8k8 TF32 with the 3xTF32 split, bf16 inputs
//   m16n8k16 with fp32 accumulation (P and dS cast to bf16 as A operands).
//
// Plain C interface (bound with ctypes); the wrapper
// (flocoder_torch/ops/kernels/na2d.py) validates shapes, dtypes and
// alignment, works out both passes' launch plans, allocates the outputs and
// the scratch, and raises if the return code is not 0.

#include "na2d_mma.cuh"

namespace {

using namespace na2d;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kQueryChunk = 32;   // queries per chunk of pass 2 (4 n8 tiles)

// Pass 1: dq, plus the log-sum-exp and delta of every (query, head).
template <typename T, int DHMAX>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
na2d_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ o, const T* __restrict__ g, T* __restrict__ dq,
                   float* __restrict__ lse, float* __restrict__ delta, int H, int W, int heads,
                   int dh, int ks, int tile_h, int tile_w, int halo_h, int halo_w, int two_buf,
                   int table, float scale) {
  using O = Op<T>;
  constexpr int NT = kUnionTiles;
  constexpr int NG = NT / O::NG;
  constexpr int NDT = Slice<DHMAX>::kTiles;     // column tiles of one accumulator slice
  extern __shared__ __align__(16) unsigned char smem[];
  const int srow = O::srow(dh);
  const int halo_px = halo_h * halo_w;
  T* sv = reinterpret_cast<T*>(smem);
  T* sk = two_buf ? sv + halo_px * srow : sv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = lane >> 2;
  const int t = lane & 3;
  int2* tab = reinterpret_cast<int2*>(sv + (1 + two_buf) * halo_px * srow) + warp * table;

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
  const size_t img = (size_t)b * H * W;
  const size_t base = img * C + (size_t)hd * dh;

  stage(sv, v + base, hr0, hc0, halo_h, halo_w, W, C, dh, srow);
  cp_async_commit();
  if (two_buf) {
    stage(sk, k + base, hr0, hc0, halo_h, halo_w, W, C, dh, srow);
    cp_async_commit();
  }

  // The warp's query patch and its union of windows, as in na2d_fwd.cu.
  const int pw = tile_w / kPatch;
  const int pr0 = r0 + (warp / pw) * kPatch;
  const int pc0 = c0 + (warp % pw) * kPatch;
  const bool live_patch = pr0 < H && pc0 < W;
  const int ra = pr0 + gi / 4, rb = ra + 2, cq = pc0 + gi % 4;
  const bool live_a = ra < H && cq < W, live_b = rb < H && cq < W;
  const int qra = min(ra, H - 1), qrb = min(rb, H - 1), qc = min(cq, W - 1);
  const int ur0 = window_start(min(pr0, H - 1), H, ks);
  const int uc0 = window_start(min(pc0, W - 1), W, ks);
  const int ubh = window_start(min(pr0 + kPatch - 1, H - 1), H, ks) - ur0 + ks;
  const int ubw = window_start(min(pc0 + kPatch - 1, W - 1), W, ks) - uc0 + ks;
  const int nu = ubh * ubw;
  const int nt = (nu + O::KS - 1) / O::KS * (O::KS / 8);
  const int wra = window_start(qra, H, ks) - ur0, wrb = window_start(qrb, H, ks) - ur0;
  const int wc = window_start(qc, W, ks) - uc0;
  for (int n = lane; n < table; n += 32) {
    int2 e = make_int2(0, 0xffff);
    if (n < nu) {
      const int kr = n / ubw, kc = n - (n / ubw) * ubw;
      e = make_int2(((ur0 - hr0 + kr) * halo_w + uc0 - hc0 + kc) * srow, (kr << 8) | kc);
    }
    tab[n] = e;
  }
  __syncwarp();

  const size_t pa = img + (size_t)qra * W + qc, pb = img + (size_t)qrb * W + qc;
  const size_t offa = pa * C + (size_t)hd * dh, offb = pb * C + (size_t)hd * dh;
  typename O::Cols kc[NG];      // the K and V halos share one layout and table
#pragma unroll
  for (int jg = 0; jg < NG; ++jg)
    if (jg * O::NG < nt) kc[jg] = O::cols(tab, jg, 1, lane, nt);

  // delta = g . o of rows g and g + 8, each lane over the channels = t mod 4.
  float da = 0.f, db = 0.f;
  if (live_patch) {
    for (int c = t; c < dh; c += 4) {
      da = fmaf(O::load(g + offa + c), O::load(o + offa + c), da);
      db = fmaf(O::load(g + offb + c), O::load(o + offb + c), db);
    }
  }
  da = warp_sum4(da);
  db = warp_sum4(db);

  if (two_buf) cp_async_wait<1>(); else cp_async_wait<0>();
  __syncthreads();

  // dP = G.V^T over the union.
  float dp[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
  if (live_patch) {
#pragma unroll 1
    for (int k0 = 0; k0 < dh; k0 += O::KS) {
      const typename O::A a = O::a_rows(g + offa, g + offb, k0, dh, t);
#pragma unroll
      for (int jg = 0; jg < NG; ++jg)
        if (jg * O::NG < nt) O::mma_cols(dp, jg, a, sv, kc[jg], k0, t, nt);
    }
  }
  if (!two_buf) {             // K takes V's buffer once every warp is done with V
    __syncthreads();
    stage(sk, k + base, hr0, hc0, halo_h, halo_w, W, C, dh, srow);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!live_patch) return;

  // S = Q.K^T, masked; exact softmax; dS = P * (dP - delta) into s.
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < dh; k0 += O::KS) {
    const typename O::A a = O::a_rows(q + offa, q + offb, k0, dh, t);
#pragma unroll
    for (int jg = 0; jg < NG; ++jg)
      if (jg * O::NG < nt) O::mma_cols(s, jg, a, sk, kc[jg], k0, t, nt);
  }
  const float scale_log2 = scale * kLog2e;
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pos = j < nt ? tab[8 * j + 2 * t + e].y : 0xffff;
      const int kr = pos >> 8, kc = pos & 0xff;
      const bool col = (unsigned)(kc - wc) < (unsigned)ks;
      s[j][e] = col && (unsigned)(kr - wra) < (unsigned)ks ? s[j][e] * scale_log2 : -INFINITY;
      s[j][2 + e] =
          col && (unsigned)(kr - wrb) < (unsigned)ks ? s[j][2 + e] * scale_log2 : -INFINITY;
      ma = fmaxf(ma, s[j][e]);
      mb = fmaxf(mb, s[j][2 + e]);
    }
  }
  ma = warp_max4(ma);
  mb = warp_max4(mb);
  float la = 0.f, lb = 0.f;
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
  const float ia = 1.f / la, ib = 1.f / lb;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = s[j][e] * ia * (dp[j][e] - da);
      s[j][2 + e] = s[j][2 + e] * ib * (dp[j][2 + e] - db);
    }
  }

  // dQ = scale * dS.K, in column slices of NDT tiles (two at dh 256).
#pragma unroll
  for (int si = 0; si < Slice<DHMAX>::kCount; ++si) {
    const int cs = Slice<DHMAX>::start(si), dw = Slice<DHMAX>::width(si, dh);
    if (dw <= 0) break;
    float acc[NDT][4];
#pragma unroll
    for (int n = 0; n < NDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT * 8 / O::KS; ++kk) {
      if (kk * O::KS < nt * 8)
        O::mma_rows(acc, O::a_acc(s, kk), sk + cs, O::rows(tab + kk * O::KS, 1, lane), dw, gi);
    }
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      if (n * 8 < dw) {
        const size_t c = cs + n * 8 + 2 * t;
        if (live_a) O::store2(dq + offa + c, acc[n][0] * scale, acc[n][1] * scale);
        if (live_b) O::store2(dq + offb + c, acc[n][2] * scale, acc[n][3] * scale);
      }
    }
  }
  if (t == 0) {
    if (live_a) {
      lse[pa * heads + hd] = (ma + log2f(la)) * kLn2;
      delta[pa * heads + hd] = da;
    }
    if (live_b) {
      lse[pb * heads + hd] = (mb + log2f(lb)) * kLn2;
      delta[pb * heads + hd] = db;
    }
  }
}

// Pass 2: dk and dv, each key patch walking the queries that see its keys.
template <typename T, int DHMAX, int QCH>
__global__ void __launch_bounds__(kMaxWarps * 32)
na2d_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    int H, int W, int heads, int dh, int ks, int tile_h, int tile_w,
                    int span_h, int span_w, int table, float scale) {
  using O = Op<T>;
  constexpr int QT = QCH / 8;        // n8 tiles of a chunk
  constexpr int QG = QT / O::NG;
  constexpr int NDT = Slice<DHMAX>::kTiles;     // column tiles of one accumulator slice
  extern __shared__ __align__(16) unsigned char smem[];
  const int srow = O::srow(dh);
  const int span_px = span_h * span_w;
  T* sq = reinterpret_cast<T*>(smem);
  T* sg = sq + span_px * srow;
  float* sl = reinterpret_cast<float*>(sg + span_px * srow);   // lse, log2 units
  float* sd = sl + span_px;                                   // delta
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gi = lane >> 2;
  const int t = lane & 3;
  int2* tab = reinterpret_cast<int2*>(sd + span_px) + warp * table;

  const int tiles_w = (W + tile_w - 1) / tile_w;
  const int n_tiles = ((H + tile_h - 1) / tile_h) * tiles_w;
  const int bh = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - bh * n_tiles;
  const int b = bh / heads;
  const int hd = bh - b * heads;
  const int r0 = (tile / tiles_w) * tile_h;
  const int c0 = (tile % tiles_w) * tile_w;
  const int r1 = min(r0 + tile_h, H) - 1;
  const int c1 = min(c0 + tile_w, W) - 1;
  // The tile's query halo: the union of its keys' query ranges.
  const int qr0 = q_lo(r0, ks);
  const int qc0 = q_lo(c0, ks);
  const int hh = q_hi(r1, H, ks) - qr0 + 1;
  const int hw = q_hi(c1, W, ks) - qc0 + 1;
  const int C = heads * dh;
  const size_t img = (size_t)b * H * W;
  const size_t base = img * C + (size_t)hd * dh;

  stage(sq, q + base, qr0, qc0, hh, hw, W, C, dh, srow);
  stage(sg, g + base, qr0, qc0, hh, hw, W, C, dh, srow);
  cp_async_commit();
  for (int p = threadIdx.x; p < hh * hw; p += blockDim.x) {
    const int pr = p / hw;
    const size_t i = (img + (size_t)(qr0 + pr) * W + (qc0 + p - pr * hw)) * heads + hd;
    sl[p] = lse[i] * kLog2e;
    sd[p] = delta[i];
  }

  // The warp's key patch, its rows g and g + 8 (clamped; keys past the
  // map's edge do not store), and its query union.
  const int pw = tile_w / kPatch;
  const int pr0 = r0 + (warp / pw) * kPatch;
  const int pc0 = c0 + (warp % pw) * kPatch;
  const bool live_patch = pr0 < H && pc0 < W;
  const int ra = pr0 + gi / 4, rb = ra + 2, cq = pc0 + gi % 4;
  const bool live_a = ra < H && cq < W, live_b = rb < H && cq < W;
  const int kra = min(ra, H - 1), krb = min(rb, H - 1), kc = min(cq, W - 1);
  const int ur0 = q_lo(min(pr0, H - 1), ks);
  const int uc0 = q_lo(min(pc0, W - 1), ks);
  const int nqh = q_hi(min(pr0 + kPatch - 1, H - 1), H, ks) - ur0 + 1;
  const int nqw = q_hi(min(pc0 + kPatch - 1, W - 1), W, ks) - uc0 + 1;
  const int nq = nqh * nqw;
  // Query table: pixel index in the halo and (window row << 16 | window col)
  // of the query; padding entries point at pixel 0 outside every window.
  for (int n = lane; n < table; n += 32) {
    int2 e = make_int2(0, 0x7fff7fff);
    if (n < nq) {
      const int qr = ur0 + n / nqw, qcn = uc0 + n - (n / nqw) * nqw;
      e = make_int2((qr - qr0) * hw + qcn - qc0,
                    (window_start(qr, H, ks) << 16) | window_start(qcn, W, ks));
    }
    tab[n] = e;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!live_patch) return;

  const size_t offa = (img + (size_t)kra * W + kc) * C + (size_t)hd * dh;
  const size_t offb = (img + (size_t)krb * W + kc) * C + (size_t)hd * dh;

  const float scale_log2 = scale * kLog2e;
  // The union in n8 tiles (whole k steps), walked in chunks of QT tiles;
  // the last chunk is cut to the tiles left. dK and dV are accumulated in
  // column slices of NDT tiles: a head of 256 walks its union twice, each
  // pass recomputing the chunks' S^T and dP^T over the whole dh, so that
  // dK and dV take the registers they take at dh 128.
  const int nqt = (nq + O::KS - 1) / O::KS * (O::KS / 8);
#pragma unroll
  for (int si = 0; si < Slice<DHMAX>::kCount; ++si) {
    const int cs = Slice<DHMAX>::start(si), dw = Slice<DHMAX>::width(si, dh);
    if (dw <= 0) break;
    float dka[NDT][4], dva[NDT][4];
#pragma unroll
    for (int n = 0; n < NDT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
#pragma unroll 1
    for (int ch = 0; ch * QT < nqt; ++ch) {
      const int ct = min(QT, nqt - ch * QT);
      const int2* ctab = tab + ch * QCH;
      typename O::Cols qcol[QG];
#pragma unroll
      for (int jg = 0; jg < QG; ++jg)
        if (jg * O::NG < ct) qcol[jg] = O::cols(ctab, jg, srow, lane, ct);
      float st[QT][4], dpt[QT][4];
#pragma unroll
      for (int j = 0; j < QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll 1
      for (int k0 = 0; k0 < dh; k0 += O::KS) {
        const typename O::A ak = O::a_rows(k + offa, k + offb, k0, dh, t);
        const typename O::A av = O::a_rows(v + offa, v + offb, k0, dh, t);
#pragma unroll
        for (int jg = 0; jg < QG; ++jg) {
          if (jg * O::NG < ct) {
            O::mma_cols(st, jg, ak, sq, qcol[jg], k0, t, ct);
            O::mma_cols(dpt, jg, av, sg, qcol[jg], k0, t, ct);
          }
        }
      }
      // P^T and dS^T of the chunk, in place (tiles past ct stay 0).
#pragma unroll
      for (int j = 0; j < QT; ++j) {
        if (j >= ct) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int2 en = ctab[8 * j + 2 * t + e];
          const int wr = en.y >> 16, wcq = en.y & 0xffff;
          const bool col = (unsigned)(kc - wcq) < (unsigned)ks;
          const float l2 = sl[en.x], d = sd[en.x];
          const float p0 =
              col && (unsigned)(kra - wr) < (unsigned)ks ? exp2f(st[j][e] * scale_log2 - l2) : 0.f;
          const float p1 = col && (unsigned)(krb - wr) < (unsigned)ks
                               ? exp2f(st[j][2 + e] * scale_log2 - l2)
                               : 0.f;
          st[j][e] = p0;
          st[j][2 + e] = p1;
          dpt[j][e] = p0 * (dpt[j][e] - d);
          dpt[j][2 + e] = p1 * (dpt[j][2 + e] - d);
        }
      }
      // dV += P^T.G, dK += dS^T.Q over the chunk's queries, this slice's
      // columns.
#pragma unroll
      for (int kk = 0; kk < QCH / O::KS; ++kk) {
        if (kk * O::KS >= ct * 8) break;
        const typename O::Rows r = O::rows(ctab + kk * O::KS, srow, lane);
        O::mma_rows(dva, O::a_acc(st, kk), sg + cs, r, dw, gi);
        O::mma_rows(dka, O::a_acc(dpt, kk), sq + cs, r, dw, gi);
      }
    }
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      if (n * 8 < dw) {
        const int c = cs + n * 8 + 2 * t;
        if (live_a) {
          O::store2(dk + offa + c, dka[n][0] * scale, dka[n][1] * scale);
          O::store2(dv + offa + c, dva[n][0], dva[n][1]);
        }
        if (live_b) {
          O::store2(dk + offb + c, dka[n][2] * scale, dka[n][3] * scale);
          O::store2(dv + offb + c, dva[n][2], dva[n][3]);
        }
      }
    }
  }
}

template <typename T, int DHMAX>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* g,
                   void* dq, void* dk, void* dv, float* lse, float* delta, int B, int H, int W,
                   int heads, int dh, int ks, int tile_h, int tile_w, int halo_h, int halo_w,
                   int two_buf, int smem1, int ktile_h, int ktile_w, int span_h, int span_w,
                   int chunk, int table2, int smem2, float scale, cudaStream_t stream) {
  using O = Op<T>;
  constexpr int QCH = kQueryChunk;
  const size_t rb = (size_t)O::srow(dh) * sizeof(T);
  // pass 1: query tiles, V/K halo
  const int warps1 = (tile_h / kPatch) * (tile_w / kPatch);
  const int table1 = ((ks + kPatch - 1) * (ks + kPatch - 1) + O::KS - 1) / O::KS * O::KS;
  const size_t need1 = (1 + two_buf) * halo_h * halo_w * rb +
                       (size_t)warps1 * table1 * 8;
  const long long blocks1 = (long long)B * heads * ((H + tile_h - 1) / tile_h) *
                            ((W + tile_w - 1) / tile_w);
  // pass 2: key tiles, query halo; the halo and table bounds are checked
  // against the widest tile and patch of this map
  const int warps2 = (ktile_h / kPatch) * (ktile_w / kPatch);
  const size_t need2 = (size_t)span_h * span_w * (2 * rb + 8) +
                       (size_t)warps2 * table2 * 8;
  const long long blocks2 = (long long)B * heads * ((H + ktile_h - 1) / ktile_h) *
                            ((W + ktile_w - 1) / ktile_w);
  int max_h = 0, max_w = 0, max_ph = 0, max_pw = 0;
  for (int r = 0; r < H; r += ktile_h)
    max_h = max(max_h, q_hi(min(r + ktile_h, H) - 1, H, ks) - q_lo(r, ks) + 1);
  for (int c = 0; c < W; c += ktile_w)
    max_w = max(max_w, q_hi(min(c + ktile_w, W) - 1, W, ks) - q_lo(c, ks) + 1);
  for (int r = 0; r < H; r += kPatch)
    max_ph = max(max_ph, q_hi(min(r + kPatch, H) - 1, H, ks) - q_lo(r, ks) + 1);
  for (int c = 0; c < W; c += kPatch)
    max_pw = max(max_pw, q_hi(min(c + kPatch, W) - 1, W, ks) - q_lo(c, ks) + 1);
  if (need1 > (size_t)smem1 || need2 > (size_t)smem2 || chunk != QCH || table2 % QCH ||
      table2 < max_ph * max_pw || span_h < max_h || span_w < max_w ||
      blocks1 > 0x7fffffffLL || blocks2 > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;

  cudaError_t err = cudaFuncSetAttribute(na2d_bwd_dq_kernel<T, DHMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(na2d_bwd_dkv_kernel<T, DHMAX, QCH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
  if (err != cudaSuccess) return err;

  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);
  na2d_bwd_dq_kernel<T, DHMAX><<<(unsigned)blocks1, warps1 * 32, smem1, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tg, static_cast<T*>(dq), lse, delta, H, W, heads,
      dh, ks, tile_h, tile_w, halo_h, halo_w, two_buf, table1, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  na2d_bwd_dkv_kernel<T, DHMAX, QCH><<<(unsigned)blocks2, warps2 * 32, smem2, stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, W, heads, dh,
      ks, ktile_h, ktile_w, span_h, span_w, table2, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const void* o, const void* g,
                     void* dq, void* dk, void* dv, float* lse, float* delta, int B, int H,
                     int W, int heads, int dh, int ks, int tile_h, int tile_w, int halo_h,
                     int halo_w, int two_buf, int smem1, int ktile_h, int ktile_w, int span_h,
                     int span_w, int chunk, int table2, int smem2, float scale,
                     cudaStream_t s) {
#define NA2D_CASE(N)                                                                      \
  case N:                                                                                 \
    return launch<T, N>(q, k, v, o, g, dq, dk, dv, lse, delta, B, H, W, heads, dh, ks,    \
                        tile_h, tile_w, halo_h, halo_w, two_buf, smem1, ktile_h, ktile_w, \
                        span_h, span_w, chunk, table2, smem2, scale, s);
  switch (dh_bucket(dh)) {
    NA2D_CASE(16) NA2D_CASE(32) NA2D_CASE(64) NA2D_CASE(128) NA2D_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef NA2D_CASE
}

bool valid_tile(int th, int tw) {
  return th >= kPatch && tw >= kPatch && th % kPatch == 0 && tw % kPatch == 0 &&
         (th / kPatch) * (tw / kPatch) <= kMaxWarps;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dh a multiple of 8 up to 256; ks up to 7.
// Pass 1's plan (tile_h, tile_w, halo_h, halo_w, two_buf, smem1) is the
// forward kernel's; pass 2's (ktile_h, ktile_w, span_h, span_w, chunk,
// table2, smem2) is the host's plan_keys. The entry checks both against the
// map and their layouts against the bytes given. lse and delta: fp32
// scratch of B*H*W*heads values each. Returns a cudaError_t (0 = both
// passes launched).
extern "C" int na2d_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* g, void* dq, void* dk, void* dv, void* lse, void* delta,
                        int dtype, int B, int H, int W, int heads, int dh, int ks, int tile_h,
                        int tile_w, int halo_h, int halo_w, int two_buf, int smem1,
                        int ktile_h, int ktile_w, int span_h, int span_w, int chunk,
                        int table2, int smem2, float scale, void* stream) {
  if (dh % 8 != 0 || dh < 8 || dh > kDhMax || ks < 1 || ks > kKsMax || ks > H || ks > W ||
      !valid_tile(tile_h, tile_w) || !valid_tile(ktile_h, ktile_w) ||
      halo_h != min(tile_h + ks - 1, H) || halo_w != min(tile_w + ks - 1, W) ||
      (two_buf != 0 && two_buf != 1) || smem1 > kSmemMax || smem2 > kSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fl = static_cast<float*>(lse);
  float* fd = static_cast<float*>(delta);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, g, dq, dk, dv, fl, fd, B, H, W, heads, dh, ks,
                                tile_h, tile_w, halo_h, halo_w, two_buf, smem1, ktile_h,
                                ktile_w, span_h, span_w, chunk, table2, smem2, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, g, dq, dk, dv, fl, fd, B, H, W, heads, dh,
                                        ks, tile_h, tile_w, halo_h, halo_w, two_buf, smem1,
                                        ktile_h, ktile_w, span_h, span_w, chunk, table2, smem2,
                                        scale, s);
  return (int)cudaErrorInvalidValue;
}
