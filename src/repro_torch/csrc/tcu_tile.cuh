// Tensor-core tile machinery of tcu_reduce.cu, tcu_scan.cu and
// matmul_scan.cu's local scan, and the wmma operand types of
// flash_attention.cu's f32 instance.
//
// The streaming loop. A warp owns a group of 16 "pieces": a piece is a
// contiguous column range of one row, [p * len, min(n, (p + 1) * len)) of
// row r for piece index v = r * pieces + p. With one piece per row they are
// the rows themselves; a few long rows are cut into many pieces so that the
// grid fills the card, and fewer than 16 rows still fill the 16 rows of a
// tile. Lane (g, q) = (lane / 4, lane % 4) loads 16 bytes of pieces g and
// g + 8 at each step (a quad reads 64 contiguous bytes of a piece), a batch
// of up to 8 steps at once, and feeds the registers to mma.sync m16n8k16
// as they are: the lane's registers are the A fragment's rows g and g + 8
// at its slots k = 2q, 2q + 1, 2q + 8, 2q + 9.
//
// - Reduce: A @ 1. With B = ones the order of k in a fragment does not
//   change a row sum, so any placement of a piece's values in its row of
//   the fragment will do.
// - Scan: A @ U. The slots hold the step's columns in a permuted order
//   col_of(k); A @ U = (A P)(P^T U), so the lane's B fragment is the
//   permuted triangle B[k][j] = (col_of(k) <= j): every output column j is
//   the prefix of the step up to column j in the natural order.
//
// f16 and bf16 go in as they are (a step is 32 columns, two k-steps).
// Tensor cores do not multiply in full f32 (TF32 keeps about 3 digits), so
// an f32 value is split into three bf16 parts in registers, x = hi + mid +
// lo exactly: hi is x with its low 16 bits cleared, mid the same of the
// remainder x - hi (at most 16 significant bits), lo the rest (at most 8;
// exact from |x| >= 2^-100 up, below which lo may lose the bits under
// 2^-133); each part times an exact 0/1 matrix is exact, and the MMAs chain
// from the smallest part up (a step is 16 columns, one k-step). Every MMA
// of a step starts from zero and its f32 result is added in registers (the
// reduce's running sum, the scan's carry), so the tensor cores' own
// accumulation spans one step only. Sums run in a fixed order: the same
// input gives the same bits on every launch.
#pragma once

#include <mma.h>

#include <type_traits>

#include "hopper.cuh"

namespace rt {

using namespace nvcuda;

// ---------------------------------------------------------------------------
// wmma operand types (flash_attention.cu's f32 instance)

constexpr int kTile = 16;               // wmma fragment edge

// Input type -> tensor-core operand type and the number of operand parts:
// f16 and bf16 go in as they are, f32 as three bf16 parts.
template <typename T>
struct Operand;
template <>
struct Operand<__half> {
  using type = __half;
  static constexpr int parts = 1;
};
template <>
struct Operand<__nv_bfloat16> {
  using type = __nv_bfloat16;
  static constexpr int parts = 1;
};
template <>
struct Operand<float> {
  using type = __nv_bfloat16;
  static constexpr int parts = 3;
};

template <typename FT>
using FragA = wmma::fragment<wmma::matrix_a, kTile, kTile, kTile, FT,
                             wmma::row_major>;
template <typename FT>
using FragB = wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, FT,
                             wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, kTile, kTile, kTile, float>;

// ---------------------------------------------------------------------------
// the streaming loop

constexpr int kWarps = 8;      // warps per block
// Steps of loads in flight per lane: the totals walk holds 8 (its registers
// are free), the scan 4 (its accumulators and B fragments take the rest).
constexpr int kReduceDepth = 8;
constexpr int kScanDepth = 4;

// Piece geometry; see the top of this file.
struct Pieces {
  long long rows, n, pieces, len;
  // fold > 1: the totals pass adds each run of `fold` pieces (2, 4, 8 or
  // 16, inside one warp's group) before writing it; with fold == pieces
  // that is the row's total, and the scan pass carries between a row's
  // pieces inside the group, in one launch.
  int fold;

  __host__ __device__ long long count() const { return rows * pieces; }
  __host__ __device__ long long groups() const {
    return (count() + 15) / 16;
  }
  // The widest fold for `pieces` pieces a row: all of them if they fit a
  // group (a power of two up to 16), else runs of 16 where they divide the
  // row (only the reduce adds runs that are not whole rows).
  __host__ static int fold_for(long long pieces, bool runs) {
    if (pieces > 1 && pieces <= 16 && 16 % pieces == 0) return (int)pieces;
    return runs && pieces % 16 == 0 ? 16 : 1;
  }
  // offset of piece v's first element in the (rows, n) array, and its
  // length; a piece past the end of its row (a folded row's tail) or of
  // the array has length 0
  __device__ void locate(long long v, long long& base, long long& ext) const {
    if (v >= count()) {
      base = 0;
      ext = 0;
    } else if (pieces == 1) {
      base = v * n;
      ext = n;
    } else {
      const long long r = v / pieces, c0 = (v - r * pieces) * len;
      base = r * n + c0;
      ext = n - c0 < len ? n - c0 : len;
      if (ext < 0) ext = 0;
    }
  }
  // steps of a piece of full length
  __device__ long long steps(int step_cols) const {
    return (len + step_cols - 1) / step_cols;
  }
};

// Per input type: the 16-bit operand type, columns per step, k-steps.
template <typename T>
struct Stream {
  using FT = T;
  static constexpr int V = 8;          // elements per 16-byte load
  static constexpr int kCols = 32;     // columns per step (quad: 64 bytes)
  static constexpr int kK = 2;         // k-steps of 16 per step
  // column (within the step) of k-step kk's slot s
  __device__ static int col_of(int kk, int s) {
    return 8 * ((s & 7) >> 1) + 4 * kk + 2 * (s >> 3) + (s & 1);
  }
};
template <>
struct Stream<float> {
  using FT = __nv_bfloat16;
  static constexpr int V = 4;
  static constexpr int kCols = 16;
  static constexpr int kK = 1;
  __device__ static int col_of(int, int s) {
    return 4 * ((s & 7) >> 1) + 2 * (s >> 3) + (s & 1);
  }
};

template <typename FT>
__device__ __forceinline__ uint32_t one_bits();
template <>
__device__ __forceinline__ uint32_t one_bits<__half>() { return 0x3C00u; }
template <>
__device__ __forceinline__ uint32_t one_bits<__nv_bfloat16>() {
  return 0x3F80u;
}

// Elements [col, col + V) of a piece starting at p (those at or past ext
// read as zero) as one 16-byte register. VEC: the piece and col are 16-byte
// aligned and ext is a multiple of V, so a vector is wholly in or out.
template <typename T, bool VEC, bool VOLATILE>
__device__ __forceinline__ uint4 load16(const T* __restrict__ p,
                                        long long col, long long ext) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (VEC && !VOLATILE) {
    if (col < ext) return __ldg(reinterpret_cast<const uint4*>(p + col));
    return make_uint4(0u, 0u, 0u, 0u);
  } else if constexpr (VEC) {
    uint4 r;
    asm volatile(
        "{\n.reg .pred p;\nsetp.lt.s64 p, %5, %6;\n"
        "mov.b32 %0, 0;\nmov.b32 %1, 0;\nmov.b32 %2, 0;\nmov.b32 %3, 0;\n"
        "@p ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p + col), "l"(col), "l"(ext));
    return r;
  } else {
    union {
      uint4 u;
      T e[V];
    } r;
#pragma unroll
    for (int j = 0; j < V; ++j)
      r.e[j] = col + j < ext ? p[col + j] : from_f32<T>(0.f);
    return r.u;
  }
}

// The high 16 bits of a and of b as one register of two bf16 (a low).
__device__ __forceinline__ uint32_t pack_hi(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}
__device__ __forceinline__ float clear_lo(float a) {
  return __uint_as_float(__float_as_uint(a) & 0xFFFF0000u);
}

// x0, x1 -> the registers of their three exact bf16 parts
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = pack_hi(x0, x1);
  const float r0 = x0 - clear_lo(x0), r1 = x1 - clear_lo(x1);
  mid = pack_hi(r0, r1);
  lo = pack_hi(r0 - clear_lo(r0), r1 - clear_lo(r1));
}

// d = sum over the step's k-steps (and f32 parts) of A b, from zero.
// a, b: the 16-byte loads of pieces g and g + 8. bk[kk]: B fragment of
// k-step kk for this n-tile.
template <typename T>
__device__ __forceinline__ void step_mma(float (&d)[4], const uint4& a,
                                         const uint4& b,
                                         const uint32_t (&bk)[2][2]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
  if constexpr (std::is_same_v<T, float>) {
    const float* fa = reinterpret_cast<const float*>(&a);
    const float* fb = reinterpret_cast<const float*>(&b);
    uint32_t hi[4], mid[4], lo[4];
    split3(fa[0], fa[1], hi[0], mid[0], lo[0]);
    split3(fb[0], fb[1], hi[1], mid[1], lo[1]);
    split3(fa[2], fa[3], hi[2], mid[2], lo[2]);
    split3(fb[2], fb[3], hi[3], mid[3], lo[3]);
    mma_16816(d, lo, bk[0][0], bk[0][1], __nv_bfloat16());
    mma_16816(d, mid, bk[0][0], bk[0][1], __nv_bfloat16());
    mma_16816(d, hi, bk[0][0], bk[0][1], __nv_bfloat16());
  } else {
    const uint32_t a0[4] = {a.x, b.x, a.y, b.y};
    const uint32_t a1[4] = {a.z, b.z, a.w, b.w};
    mma_16816(d, a0, bk[0][0], bk[0][1], T());
    mma_16816(d, a1, bk[1][0], bk[1][1], T());
  }
}

// The lane's B fragment of each k-step for n-tile t (output columns 8t ..
// 8t + 7 of the step): rows k = 2q, 2q + 1 (register 0) and 2q + 8, 2q + 9
// (register 1) of column j = 8t + g. SCAN: the permuted triangle, B[k][j] =
// col_of(k) <= j; else ones.
template <typename T, bool SCAN>
__device__ __forceinline__ void b_frag(uint32_t (&bk)[2][2], int t,
                                       int lane) {
  using S = Stream<T>;
  const uint32_t one = one_bits<typename S::FT>();
  const int g = lane >> 2, q = lane & 3, j = 8 * t + g;
  auto on = [&](int kk, int k) {
    return kk < S::kK && (!SCAN || S::col_of(kk, k) <= j);
  };
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = 2 * q + 8 * r;
      bk[kk][r] = (on(kk, k) ? one : 0u) | (on(kk, k + 1) ? one << 16 : 0u);
    }
}

// Totals of the warp's group of 16 pieces folded to its rows, in a fixed
// order: with p = pieces (2, 4, 8) a row's pieces are lanes g .. g + p - 1
// of one half, summed by a butterfly over g (every lane of the row ends
// with the same bits); with 16, the halves' sums are added.
__device__ __forceinline__ float fold_sum(float v, int p) {
  for (int m = 4; m < 4 * p && m < 32; m <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Exclusive prefix, over the pieces of each row within the group, of the
// totals ca (pieces g) and cb (pieces g + 8), in a fixed order.
__device__ __forceinline__ void fold_carries(float& ca, float& cb, int p,
                                             int g) {
  const int seg = p < 8 ? p : 8;          // pieces of a row in one half
  float ia = ca, ib = cb;
  for (int d = 1; d < seg; d <<= 1) {
    const float ua = __shfl_up_sync(0xffffffffu, ia, 4 * d);
    const float ub = __shfl_up_sync(0xffffffffu, ib, 4 * d);
    if (g % seg >= d) {
      ia += ua;
      ib += ub;
    }
  }
  float ea = __shfl_up_sync(0xffffffffu, ia, 4);
  float eb = __shfl_up_sync(0xffffffffu, ib, 4);
  if (g % seg == 0) ea = eb = 0.f;
  if (p == 16)      // pieces 8 .. 15 follow the whole first half
    eb += __shfl_sync(0xffffffffu, ia, 28 + (threadIdx.x & 3));
  ca = ea;
  cb = eb;
}

// Where a lane's pieces g and g + 8 of a group lie: their first elements'
// offsets and lengths.
struct Lanes {
  long long ba, ea, bb, eb;
};

// One walk over K groups of 16 pieces (groups item, item + stride, ...;
// K > 1 only for whole rows shorter than a batch, so that short rows still
// keep a batch of loads in flight), D / K steps a batch: every load of a
// batch is issued, then the batch is consumed in order.
//   SCAN false: ca, cb += the totals of pieces g and g + 8.
//   SCAN true:  out (x's layout) = the inclusive scan of every piece from
//               the carries ca, cb.
// The totals walk issues its loads as volatile asm, so that a batch's loads
// stay ahead of its MMAs (volatile too); the scan's loads are left to the
// compiler, which overlaps them with the previous batch's stores.
template <typename T, bool VEC, int D, int K, bool SCAN, int NT>
__device__ __forceinline__ void walk(const T* __restrict__ x,
                                     float* __restrict__ out,
                                     const Lanes (&at)[K], float (&ca)[K],
                                     float (&cb)[K],
                                     const uint32_t (&bk)[NT][2][2],
                                     long long steps, long long stride,
                                     int lane) {
  using S = Stream<T>;
  constexpr int SS = D / K;                  // steps per batch
  static_assert(SS >= 1 && SS * K == D, "a batch is D steps");
  static_assert(NT == (SCAN ? S::kCols / 8 : 1), "n-tiles of 8 columns");
  const int q = lane & 3, last = (lane & ~3) | 3;
  for (long long s0 = 0; s0 < steps; s0 += SS) {
    uint4 ra[K][SS], rb[K][SS];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < SS; ++i) {
        const long long col = (s0 + i) * stride + q * S::V;
        ra[k][i] = load16<T, VEC, !SCAN>(x + at[k].ba, col, at[k].ea);
        rb[k][i] = load16<T, VEC, !SCAN>(x + at[k].bb, col, at[k].eb);
      }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < SS; ++i) {
        if (s0 + i >= steps) break;
        float d[NT][4];
#pragma unroll
        for (int t = 0; t < NT; ++t)
          step_mma<T>(d[t], ra[k][i], rb[k][i], bk[t]);
        if constexpr (!SCAN) {
          ca[k] += d[0][0];
          cb[k] += d[0][2];
        } else {
          // the step's row totals: column kCols - 1, held by lane q = 3
          const float ta = __shfl_sync(0xffffffffu, d[NT - 1][1], last);
          const float tb = __shfl_sync(0xffffffffu, d[NT - 1][3], last);
          float* oa = out + at[k].ba;
          float* ob = out + at[k].bb;
          const long long ea = at[k].ea, eb = at[k].eb;
          const long long c0 = (s0 + i) * S::kCols + 2 * q;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const long long c = c0 + 8 * t;
            const float2 wa = make_float2(d[t][0] + ca[k], d[t][1] + ca[k]);
            const float2 wb = make_float2(d[t][2] + cb[k], d[t][3] + cb[k]);
            if constexpr (VEC) {   // ext is even: a pair is wholly in or out
              if (c < ea) __stcs(reinterpret_cast<float2*>(oa + c), wa);
              if (c < eb) __stcs(reinterpret_cast<float2*>(ob + c), wb);
            } else {
              if (c < ea) oa[c] = wa.x;
              if (c + 1 < ea) oa[c + 1] = wa.y;
              if (c < eb) ob[c] = wb.x;
              if (c + 1 < eb) ob[c + 1] = wb.y;
            }
          }
          ca[k] += ta;
          cb[k] += tb;
        }
      }
  }
}

// The streaming loop: each warp walks its groups, grid-stride, K at a time.
//   SCAN false: dst[v / fold] = total of pieces v .. v + fold - 1.
//   SCAN true:  out = the inclusive scan of every piece from cin[v] (cin
//               null: from zero). Folded, the group is walked twice: its
//               pieces' totals first, whose fixed-order prefix over each
//               row gives every piece its carry, then the scan (the second
//               read mostly hits L2).
template <typename T, bool VEC, int D, int K, bool SCAN>
__device__ __forceinline__ void stream(const T* __restrict__ x,
                                       float* __restrict__ out,
                                       const float* __restrict__ cin,
                                       const Pieces& geo) {
  using S = Stream<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, q = lane & 3;
  const bool fold = geo.fold > 1;
  const int p = geo.fold;
  const long long steps = geo.steps(S::kCols);
  const long long stride = (long long)gridDim.x * kWarps;
  // the B fragments of A @ 1 and A @ U
  constexpr int NT = S::kCols / 8;
  uint32_t ones[1][2][2], tri[NT][2][2];
  b_frag<T, false>(ones[0], 0, lane);
  if constexpr (SCAN) {
#pragma unroll
    for (int t = 0; t < NT; ++t) b_frag<T, true>(tri[t], t, lane);
  }
  for (long long item = (long long)blockIdx.x * kWarps + warp;
       item < geo.groups(); item += K * stride) {
    Lanes at[K];
    float ca[K], cb[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long v = (item + k * stride) * 16 + g;
      geo.locate(v, at[k].ba, at[k].ea);
      geo.locate(v + 8, at[k].bb, at[k].eb);
      ca[k] = SCAN && cin != nullptr && at[k].ea > 0 ? cin[v] : 0.f;
      cb[k] = SCAN && cin != nullptr && at[k].eb > 0 ? cin[v + 8] : 0.f;
    }
    if constexpr (SCAN) {
      if (fold) {
        walk<T, VEC, kReduceDepth, K, false>(x, out, at, ca, cb, ones, steps,
                                             S::kCols, lane);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          // one value per quad (its columns of A @ 1 are equal), then the
          // sum of the row's earlier pieces
          ca[k] = __shfl_sync(0xffffffffu, ca[k], lane & ~3);
          cb[k] = __shfl_sync(0xffffffffu, cb[k], lane & ~3);
          fold_carries(ca[k], cb[k], p, g);
        }
      }
      walk<T, VEC, D, K, true>(x, out, at, ca, cb, tri, steps, S::kCols,
                               lane);
    } else {
      // A group of 16 whole pieces that are added up (runs of 16 pieces of
      // one row, none ragged) is one contiguous block: read it as such,
      // row g of step s being its chunk 16 s + g, so that each load
      // instruction covers 512 contiguous bytes (the sum is the same set
      // of values, in another fixed order).
      const bool block = fold && p == 16 && geo.pieces * geo.len == geo.n &&
                         geo.len % S::kCols == 0;
      if (block) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const long long base = __shfl_sync(0xffffffffu, at[k].ba, 0);
          const long long ext = at[k].ea > 0 ? steps * 16 * S::kCols : 0;
          at[k] = Lanes{base + g * S::kCols, ext,
                        base + (8 + g) * S::kCols, ext};
        }
      }
      walk<T, VEC, D, K, false>(x, out, at, ca, cb, ones, steps,
                                block ? 16 * S::kCols : S::kCols, lane);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long v = (item + k * stride) * 16 + g;
        if (fold) {
          const float ta = fold_sum(ca[k], p), tb = fold_sum(cb[k], p);
          if (q == 0 && g % p == 0 && v < geo.count())
            out[v / p] = p == 16 ? ta + tb : ta;
          if (p < 16 && q == 0 && g % p == 0 && v + 8 < geo.count())
            out[(v + 8) / p] = tb;
        } else {
          if (q == 0 && v < geo.count()) out[v] = ca[k];
          if (q == 0 && v + 8 < geo.count()) out[v + 8] = cb[k];
        }
      }
    }
  }
}

// Groups a warp takes at once: for whole rows (one piece a row) shorter
// than half a batch of `depth` steps, up to 4 (more would cost the
// registers of a second block per SM).
inline int batch_groups(const Pieces& geo, int step_cols, int depth) {
  const long long steps = (geo.len + step_cols - 1) / step_cols;
  int k = 1;
  while (geo.pieces == 1 && k < 4 && steps * k * 2 <= depth) k *= 2;
  return k;
}

// Fixed-order sums over each row's pieces, ws (rows, pieces), for rows
// with more pieces than a group: one block per row, blockDim.x threads (a
// multiple of 32, at most 1024). The row is walked in tiles of 256 pieces a
// warp: lane l reads pieces 32j + l of its warp's tile (coalesced), the
// eight rows j are scanned by shuffles in order, the warps' totals through
// shared memory, and a running sum carries from one block tile to the next.
// EXCL: cin[r, p] = sum of the pieces < p of row r (the scan's carries);
// else out[r] = sum of all of row r's pieces.
template <bool EXCL>
__device__ __forceinline__ void combine_pieces(const float* __restrict__ ws,
                                               float* __restrict__ dst,
                                               long long pieces) {
  __shared__ float warp_s[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  const float* row = ws + blockIdx.x * pieces;
  float* crow = dst + blockIdx.x * pieces;
  float offset = 0.f;          // sum of the pieces before this block tile
  for (long long t0 = 0; t0 < pieces; t0 += 256LL * nw) {
    const long long w0 = t0 + 256LL * warp;
    float v[8], ex[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long p = w0 + 32 * j + lane;
      v[j] = p < pieces ? row[p] : 0.f;
    }
    float run = 0.f;           // sum of this warp's rows j before
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float inc = v[j];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      const float e = __shfl_up_sync(0xffffffffu, inc, 1);
      ex[j] = run + (lane == 0 ? 0.f : e);
      run += __shfl_sync(0xffffffffu, inc, 31);
    }
    if (lane == 0) warp_s[warp] = run;
    __syncthreads();
    if (warp == 0) {
      float w = lane < nw ? warp_s[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += u;
      }
      if (lane < nw) warp_s[lane] = w;      // inclusive over warps
    }
    __syncthreads();
    if constexpr (EXCL) {
      const float base = warp > 0 ? offset + warp_s[warp - 1] : offset;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long p = w0 + 32 * j + lane;
        if (p < pieces) crow[p] = base + ex[j];
      }
    }
    offset += warp_s[nw - 1];
    __syncthreads();
  }
  if constexpr (!EXCL) {
    if (threadIdx.x == 0) dst[blockIdx.x] = offset;
  }
}

// The totals pass, dst[v] = sum of piece v (tcu_reduce.cu, and tcu_scan.cu's
// first launch), and the scan pass, out = the scan of every piece from
// cin[v] (tcu_scan.cu; matmul_scan.cu's local scan, cin null).
template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(kWarps * 32)
    piece_totals_kernel(const T* __restrict__ x, float* __restrict__ dst,
                        Pieces geo) {
  stream<T, VEC, kReduceDepth, K, false>(x, dst, nullptr, geo);
}

template <typename T, bool VEC, int K>
__global__ void __launch_bounds__(kWarps * 32)
    piece_scan_kernel(const T* __restrict__ x, float* __restrict__ out,
                      const float* __restrict__ cin, Pieces geo) {
  stream<T, VEC, kScanDepth, K, true>(x, out, cin, geo);
}

inline bool vec_ok(const void* x, long long n, long long len, int elem_bytes) {
  const int v = 16 / elem_bytes;
  return n % v == 0 && len % v == 0 && aligned16(x);
}

// Launch the totals or the scan pass over x's pieces: the 16-byte load path
// where x, n and len allow, with the K of batch_groups, on at most `blocks`
// blocks.
template <typename T, bool SCAN>
void launch_pass(const T* x, float* out, const float* cin, const Pieces& geo,
                 int blocks, cudaStream_t stream) {
  constexpr int D = SCAN ? kScanDepth : kReduceDepth;
  auto go = [&](auto vec, auto kk) {
    constexpr bool V = decltype(vec)::value;
    constexpr int K = decltype(kk)::value;
    const long long need =
        (geo.groups() + (long long)kWarps * K - 1) / ((long long)kWarps * K);
    const unsigned grid = (unsigned)(need < blocks ? need : blocks);
    if constexpr (SCAN)
      piece_scan_kernel<T, V, K><<<grid, kWarps * 32, 0, stream>>>(
          x, out, cin, geo);
    else
      piece_totals_kernel<T, V, K><<<grid, kWarps * 32, 0, stream>>>(
          x, out, geo);
  };
  using std::integral_constant;
  if (!vec_ok(x, geo.n, geo.len, sizeof(T)))
    return go(std::false_type(), integral_constant<int, 1>());
  const int k = batch_groups(geo, Stream<T>::kCols, D);
  if (k >= 4) return go(std::true_type(), integral_constant<int, 4>());
  if (k >= 2) return go(std::true_type(), integral_constant<int, 2>());
  go(std::true_type(), integral_constant<int, 1>());
}

template <typename T>
void launch_totals(const T* x, float* dst, const Pieces& geo, int blocks,
                   cudaStream_t stream) {
  launch_pass<T, false>(x, dst, nullptr, geo, blocks, stream);
}

template <typename T>
void launch_scan(const T* x, float* out, const float* cin, const Pieces& geo,
                 int blocks, cudaStream_t stream) {
  launch_pass<T, true>(x, out, cin, geo, blocks, stream);
}

}  // namespace rt
