// Tensor-core tile machinery shared by tcu_reduce.cu, tcu_scan.cu and
// matmul_scan.cu.
//
// A warp owns 16 segments (rows of the row-major (rows, n) input) and walks
// their columns kCols at a time: it stages a 16 x kCols block in shared
// memory as tensor-core operands (zero-filled outside the valid range) and
// multiplies each 16 x 16 fragment by a constant 16 x 16 matrix with
// nvcuda::wmma, accumulating in f32.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace rt {

using namespace nvcuda;

constexpr int kTile = 16;               // wmma fragment edge
constexpr int kCols = 32;               // columns staged per step: 2 fragments
constexpr int kWarps = 8;               // warps per block
constexpr int kPlane = kTile * kCols;   // operands of one staged part

// Input type -> tensor-core operand type and the number of operand parts.
// f16 and bf16 go in as they are. Tensor cores do not multiply in full f32
// (TF32 keeps about 3 digits), so an f32 input is split into three bf16
// parts x = hi + mid + lo; each part times an exact 0/1 matrix is exact, so
// three MMAs give the f32 result up to accumulation order.
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

template <typename T>
__device__ __forceinline__ void put(typename Operand<T>::type* s, int idx,
                                    T v) {
  if constexpr (Operand<T>::parts == 1) {
    s[idx] = v;
  } else {
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    const float r = v - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r);
    const __nv_bfloat16 lo = __float2bfloat16_rn(r - __bfloat162float(mid));
    s[idx] = hi;
    s[kPlane + idx] = mid;
    s[2 * kPlane + idx] = lo;
  }
}

// Stage rows [row0, row0 + 16) x columns [col0, col0 + kCols) of x (row
// stride ld) into s; entries at or past row `rows` or column `col_end` are
// zero. VEC: 16-byte loads (ld and col_end are multiples of the vector
// width and x is 16-byte aligned, so a vector is wholly in or out).
template <typename T, bool VEC>
__device__ __forceinline__ void stage(const T* __restrict__ x, long long rows,
                                      long long ld, long long col_end,
                                      long long row0, long long col0,
                                      typename Operand<T>::type* s,
                                      int lane) {
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    constexpr int kPerRow = kCols / V;
    for (int i = lane; i < kTile * kPerRow; i += 32) {
      const int r = i / kPerRow, c = (i % kPerRow) * V;
      const long long gr = row0 + r, gc = col0 + c;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (gr < rows && gc < col_end)
        raw = *reinterpret_cast<const uint4*>(x + gr * ld + gc);
      if constexpr (Operand<T>::parts == 1) {
        *reinterpret_cast<uint4*>(s + r * kCols + c) = raw;
      } else {
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) put<T>(s, r * kCols + c + j, v[j]);
      }
    }
  } else {
    for (int i = lane; i < kTile * kCols; i += 32) {
      const int r = i / kCols, c = i % kCols;
      const long long gr = row0 + r, gc = col0 + c;
      const T v = (gr < rows && gc < col_end) ? x[gr * ld + gc]
                                              : from_f32<T>(0.f);
      put<T>(s, i, v);
    }
  }
}

// acc += (sum over parts of staged fragment f) @ b
template <typename T>
__device__ __forceinline__ void mma_staged(
    FragC& acc, const typename Operand<T>::type* s, int f,
    const FragB<typename Operand<T>::type>& b) {
  FragA<typename Operand<T>::type> a;
#pragma unroll
  for (int p = 0; p < Operand<T>::parts; ++p) {
    wmma::load_matrix_sync(a, s + p * kPlane + f * kTile, kCols);
    wmma::mma_sync(acc, a, b, acc);
  }
}

// Inclusive scan of rows [row0, row0 + 16) over columns [lo, hi) of x (row
// stride n) into out, by one warp: each 16-wide tile times U (tile @ U is a
// row-wise scan on the tensor cores), plus the running per-row carry, which
// then advances by the tile's last column. carry (16 floats, shared) holds
// the sums before lo on entry and the sums up to hi on exit. lo is a
// multiple of kCols.
template <typename T, bool VEC>
__device__ __forceinline__ void scan_range(
    const T* __restrict__ x, float* __restrict__ out, long long rows,
    long long n, long long row0, long long lo, long long hi,
    typename Operand<T>::type* stage_s, float* tile_s, float* carry,
    const FragB<typename Operand<T>::type>& u, int lane) {
  for (long long col0 = lo; col0 < hi; col0 += kCols) {
    stage<T, VEC>(x, rows, n, hi, row0, col0, stage_s, lane);
    __syncwarp();
    for (int f = 0; f < kCols / kTile; ++f) {
      const long long c0 = col0 + f * kTile;
      if (c0 >= hi) break;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      mma_staged<T>(acc, stage_s, f, u);
      wmma::store_matrix_sync(tile_s, acc, kTile, wmma::mem_row_major);
      __syncwarp();
      for (int i = lane; i < kTile * kTile; i += 32) {
        const int r = i / kTile;
        const long long gr = row0 + r, gc = c0 + i % kTile;
        if (gr < rows && gc < hi) out[gr * n + gc] = tile_s[i] + carry[r];
      }
      __syncwarp();
      if (lane < kTile) carry[lane] += tile_s[lane * kTile + kTile - 1];
      __syncwarp();
    }
  }
}

// Warps per group of 16 rows: split the columns across up to kWarps warps
// when there are too few row groups to give every SM its 64 resident warps,
// keeping at least 64 columns per warp.
inline int warps_per_group(long long rows, long long n) {
  const long long groups = (rows + kTile - 1) / kTile;
  const long long target = 64LL * sm_count();
  int wpg = 1;
  while (wpg < kWarps && groups * wpg < target && 2LL * wpg * 64 <= n)
    wpg *= 2;
  return wpg;
}

inline bool vec_ok(const void* x, long long n, int elem_bytes) {
  return n % (16 / elem_bytes) == 0 && aligned16(x);
}

}  // namespace rt
