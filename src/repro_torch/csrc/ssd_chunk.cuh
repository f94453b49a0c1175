// The chunk body shared by ssd_scan.cu (state carried across chunks) and
// matmul_scan.cu's local SSD pass (no carry), in two instances chosen by
// dtype and shape before the launch (ssd_mma_fits):
//
// - f16 / bf16 with q <= 64, P <= 64, N <= 128, P and N multiples of 8 (the
//   served shapes): the four products of a chunk on the tensor cores
//   (mma.sync m16n8k16, f32 accumulation), every operand tile staged by
//   cp.async into padded 16-bit shared memory and read with ldmatrix.
//   B, C and X enter exactly, in their own type. The operands formed in the
//   kernel in f32 -- G o dt (the masked, decayed C B^T scaled by dt),
//   X o w o dt (the state product's weights folded into X, not B: half the
//   values at P = 64, N = 128, and split by the warp that uses them) and
//   the carried state H -- enter as two 16-bit values, hi + lo, each
//   multiplied against the exact operand: 16 (bf16) or 22 (f16)
//   significant bits where one rounding keeps 8 or 11, which holds the
//   local pass to 1e-4 of the f32 version (a single bf16 rounding misses it
//   by 6x; tests/test_torch_ssd_operands.py). f16 uses f16 pairs (exact
//   against f16 X, B, C; bf16 pairs would need X, B, C split too), and
//   carries H into C H scaled by a power of two per warp, so that a state
//   entry above f16's 65504 cannot overflow the pair.
// - everything else (f32, mixed dtypes upcast by the wrapper, the weighted
//   scan's H = G = P = N = 1 with stride-0 dt, b, c): the first version's
//   f32 FMA loops, each product giving a thread a 4x4 register tile whose
//   column operand is read as float4 from a [k][col] array in shared
//   memory.
#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace rt {

constexpr int kSsdThreads = 256;

struct SsdDims {
  int B, L, H, G, P, N, q;
  long long sxb, sxl, sxh;   // x (B, L, H, P), p contiguous
  long long sdb, sdl, sdh;   // dt (B, L, H)
  long long slb, sll, slh;   // lambda (B, L, H)
  long long sbb, sbl, sbg;   // b (B, L, G, N), n contiguous
  long long scb, scl, scg;   // c (B, L, G, N), n contiguous
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Row strides of the f32 B^T tile (np rows of q steps) and C tile (q rows
// of np): q + 4 is 4 times an odd number for every q that is a multiple of
// 8, and the C stride is 8 more than a multiple of 32, so that the staging
// lanes, on 4 neighbouring steps t x 8 neighbouring n, hit 32 different
// banks in both; rows stay 16-byte aligned for the float4 reads.
__host__ __device__ inline int bt_stride(int q) { return q + 4; }
__host__ __device__ inline int cs_stride(int np) {
  return ((np + 31) & ~31) + 8;
}

// Inclusive scan of cum[0:q) in place by one warp; then, if wv is given,
// wv[t] = exp(cum[q-1] - cum[t]).
__device__ __forceinline__ void chunk_cumsum(float* cum, float* wv, int q,
                                             int lane) {
  const int per = (q + 31) / 32;
  const int s = lane * per, e = min(q, s + per);
  float run = 0.f;
  for (int t = s; t < e; ++t) {
    run += cum[t];
    cum[t] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);  // shift, not subtract
  if (lane == 0) excl = 0.f;
  for (int t = s; t < e; ++t) cum[t] += excl;
  __syncwarp();
  if (wv == nullptr) return;
  const float last = cum[q - 1];
  for (int t = lane; t < q; t += 32) wv[t] = expf(last - cum[t]);
}

// Stage the chunk of steps [c0, c0 + q) of (batch bi, head h, group g):
// bt = B^T (np, bt_stride(q)), cs = C (q, cs_stride(np)), xs = dt * x
// (q, pp), cum = lambda (q). Steps past L and the padding columns past N
// and P are zero, which leaves every product of the chunk exact. B and C
// are staged by a warp at a time over 4 steps x 8 neighbouring n: the
// transposed B^T writes and the C writes then hit 32 banks each, where
// lanes on 32 neighbouring n would send every B^T write to one bank.
template <typename T>
__device__ __forceinline__ void stage_chunk(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ lam, const T* __restrict__ bm,
    const T* __restrict__ cm, const SsdDims& d, int bi, int h, int g,
    int c0, float* bt, float* cs, float* xs, float* cum, int tid) {
  const int q = d.q, pp = round4(d.P), np = round4(d.N);
  const int ldb = bt_stride(q), ldc = cs_stride(np);
  const int ngrp = (np + 7) / 8, lane = tid % 32;
  for (int grp = tid / 32; grp < (q / 4) * ngrp; grp += kSsdThreads / 32) {
    const int t = (grp / ngrp) * 4 + lane / 8, n = (grp % ngrp) * 8 + lane % 8;
    if (n >= np) continue;
    const int l = c0 + t;
    const bool ok = l < d.L && n < d.N;
    bt[n * ldb + t] =
        ok ? to_f32(bm[bi * d.sbb + l * d.sbl + g * d.sbg + n]) : 0.f;
    cs[t * ldc + n] =
        ok ? to_f32(cm[bi * d.scb + l * d.scl + g * d.scg + n]) : 0.f;
  }
  for (int i = tid; i < q * pp; i += kSsdThreads) {
    const int t = i / pp, p = i % pp, l = c0 + t;
    xs[i] = (l < d.L && p < d.P)
                ? to_f32(x[bi * d.sxb + l * d.sxl + h * d.sxh + p]) *
                      dt[bi * d.sdb + l * d.sdl + h * d.sdh]
                : 0.f;
  }
  for (int t = tid; t < q; t += kSsdThreads) {
    const int l = c0 + t;
    cum[t] = l < d.L ? lam[bi * d.slb + l * d.sll + h * d.slh] : 0.f;
  }
}

// gs = (C B^T) o exp(Lambda_t - Lambda_s), zero above the diagonal. The
// mask s > t is applied before the exp: an inf * 0 would poison the row.
__device__ __forceinline__ void masked_cb(const float* bt, const float* cs,
                                          const float* cum, float* gs, int q,
                                          int np, int tid) {
  const int nt = q / 4, ldb = bt_stride(q), ldc = cs_stride(np);
  for (int tile = tid; tile < nt * nt; tile += kSsdThreads) {
    const int t0 = (tile / nt) * 4, s0 = (tile % nt) * 4;
    float acc[4][4] = {};
    if (s0 <= t0 + 3) {
      for (int k = 0; k < np; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(bt + k * ldb + s0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = cs[(t0 + i) * ldc + k];
          acc[i][0] += a * bv.x;
          acc[i][1] += a * bv.y;
          acc[i][2] += a * bv.z;
          acc[i][3] += a * bv.w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + i, s = s0 + j;
        gs[t * q + s] = s <= t ? acc[i][j] * expf(cum[t] - cum[s]) : 0.f;
      }
  }
}

// yi = rows [t0, t0 + 4) x columns [p0, p0 + 4) of gs (dt o X); gs is zero
// for k > t, so the loop stops at the tile's last row.
__device__ __forceinline__ void intra_tile(const float* gs, const float* xs,
                                           int q, int pp, int t0, int p0,
                                           float (&yi)[4][4]) {
  for (int k = 0; k < t0 + 4; ++k) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + k * pp + p0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float gv = gs[(t0 + i) * q + k];
      yi[i][0] += gv * xv.x;
      yi[i][1] += gv * xv.y;
      yi[i][2] += gv * xv.z;
      yi[i][3] += gv * xv.w;
    }
  }
}

// acc = rows [n0, n0 + 4) x columns [p0, p0 + 4) of the chunk's state
// contribution (B o w)^T (dt o X), w = wv = exp(Lambda_last - Lambda).
__device__ __forceinline__ void state_tile(const float* bt, const float* xs,
                                           const float* wv, int q, int pp,
                                           int n0, int p0,
                                           float (&acc)[4][4]) {
  const int ldb = bt_stride(q);
  for (int k = 0; k < q; ++k) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + k * pp + p0);
    const float w = wv[k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float bv = bt[(n0 + i) * ldb + k] * w;
      acc[i][0] += bv * xv.x;
      acc[i][1] += bv * xv.y;
      acc[i][2] += bv * xv.z;
      acc[i][3] += bv * xv.w;
    }
  }
}

// ---------------------------------------------------------------------------
// f16 / bf16: the chunk body on the tensor cores
//
// A block of four warps takes one chunk of a (batch, head) at a time,
// staged as 16-bit tiles of 64 rows: B (s, n) and C (t, n) at 128 columns,
// X (s, p) at 64, plus dt and lambda (f32). Warp w owns rows p = 16w .. 16w
// + 15 of the transposed outputs (P x q for y, P x N for the state), so
// that the state H^T stays in its registers as an mma accumulator and
// enters C H as the register A operand; X^T is the A operand of the other
// two products.
// Per chunk:
//   1. Lambda = cumsum(lambda) by shuffles in every warp.
//   2. G o dt: the 20 tiles of C B^T (16 rows t x 8 columns s) on and
//      below the diagonal, five per warp; the mask s > t before the exp and
//      the scale exp(Lambda_t - Lambda_s) dt_s are applied in registers,
//      and hi/lo 16-bit pairs go to shared memory.
//   3. y^T = exp(Lambda_t) H^T C^T + X^T (G o dt)^T (the triangle only).
//   4. H^T = exp(Lambda_last) H^T + (X o w o dt)^T B.
// Tile rows are padded by 16 bytes (kRowN, kRowP), so that ldmatrix reads
// its 8 rows from 8 different bank groups.

constexpr int kTcQ = 64;         // rows of a chunk tile (q <= 64)
constexpr int kTcN = 128;        // largest N
constexpr int kTcP = 64;         // largest P (16 rows per warp)
constexpr int kTcThreads = 128;  // four warps

inline bool ssd_mma_fits(int dtype, int q, int P, int N) {
  return (dtype == kF16 || dtype == kBF16) && q >= 16 && q <= kTcQ &&
         q % 16 == 0 && P >= 1 && P <= kTcP && P % 8 == 0 && N >= 1 &&
         N <= kTcN && N % 8 == 0;
}

// The rows the tensor-core instance reads with 16-byte copies: aligned
// bases, and strides of x, b, c that are multiples of 8 elements (a
// dimension of extent 1 has no stride to check).
inline bool tc_rows_aligned(const void* x, const void* b, const void* c,
                            const SsdDims& d) {
  const long long st[] = {d.sxb, d.sxl, d.sxh, d.sbb, d.sbl,
                          d.sbg, d.scb, d.scl, d.scg};
  const int ext[] = {d.B, d.L, d.H, d.B, d.L, d.G, d.B, d.L, d.G};
  for (int i = 0; i < 9; ++i)
    if (ext[i] > 1 && st[i] % 8) return false;
  return aligned16(x) && aligned16(b) && aligned16(c);
}

// Row pitches in bytes: 16-bit rows of N columns (B, C) or of P columns
// (X, the G tiles, y), and f32 rows of P columns (the staged outputs of the
// local pass), each padded by 16 bytes. The 8 rows that an ldmatrix reads,
// and the rows a warp's transposed stores write, then fall in different
// banks, and every address a lane forms is its base plus a constant.
constexpr int kRowN = kTcN * 2 + 16;
constexpr int kRowP = kTcP * 2 + 16;
constexpr int kRowF = kTcP * 4 + 16;

// byte offsets in a chunk's stage
struct TcStage {
  static constexpr int kB = 0;                        // (s, n) 16-bit
  static constexpr int kC = kB + kTcQ * kRowN;        // (t, n)
  static constexpr int kX = kC + kTcQ * kRowN;        // (s, p)
  static constexpr int kDt = kX + kTcQ * kRowP;       // dt (s) f32
  static constexpr int kLam = kDt + kTcQ * 4;         // lambda (s) f32
  static constexpr int kBytes = kLam + kTcQ * 4;
};
// the G o dt pair (t, s), 16-bit, hi then lo; then the per-warp Lambda,
// w o dt and exp(Lambda) (f32)
constexpr int kTcGBytes = 2 * kTcQ * kRowP;
constexpr int kTcVecBytes = 3 * 4 * kTcQ * 4;
// the f32 staging of the local pass's outputs fits in what it reuses: y
// (q x P) in the G tiles, S (N x P) in the B and C tiles
static_assert(kTcQ * kRowF <= kTcGBytes, "y staging");
static_assert(kTcN * kRowF <= 2 * kTcQ * kRowN, "S staging");

// byte offset of 16-byte chunk ch of row r, rows `pitch` bytes apart
__device__ __forceinline__ int tile_chunk(int r, int ch, int pitch) {
  return r * pitch + ch * 16;
}
// byte offset of element c of row r, 16-bit (EB = 2) or f32 (EB = 4)
template <int EB>
__device__ __forceinline__ int tile_elem(int r, int c, int pitch) {
  return r * pitch + c * EB;
}

template <typename T>
__device__ __forceinline__ uint32_t pack_pair(T lo, T hi) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(&lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

// v0, v1 (neighbouring columns) as 16-bit hi and lo pairs: v = hi + lo to
// 16 (bf16) or 22 (f16) significant bits
template <typename T>
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const T h0 = from_f32<T>(v0), h1 = from_f32<T>(v1);
  hi = pack_pair(h0, h1);
  lo = pack_pair(from_f32<T>(v0 - to_f32(h0)), from_f32<T>(v1 - to_f32(h1)));
}

// Issue the cp.async copies of the chunk of steps [c0, c0 + q) into a
// stage, from x, dt, lambda at (batch, head) and b, c at (batch, group)
// (base pointers with those offsets applied). Rows past q or L, and
// columns past N or P, are zero-filled. Needs P and N multiples of 8 and
// 16-byte aligned rows of x, b, c. The loops stay rolled, which keeps the
// chunk loop's code short.
template <typename T>
__device__ __forceinline__ void tc_load_chunk(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ lam, const T* __restrict__ bm,
    const T* __restrict__ cm, const SsdDims& d, int c0, unsigned char* st,
    int tid) {
  constexpr int kNc = kTcN / 8, kPc = kTcP / 8;   // 16-byte chunks a row
#pragma unroll 1
  for (int i = tid; i < kTcQ * kNc; i += kTcThreads) {
    const int t = i / kNc, ch = i % kNc, l = c0 + t;
    const bool ok = t < d.q && l < d.L && ch * 8 < d.N;
    const int off = tile_chunk(t, ch, kRowN);
    const long long lc = ok ? l : 0, cc = ok ? ch * 8 : 0;
    cp_async16(st + TcStage::kB + off, bm + lc * d.sbl + cc, ok);
    cp_async16(st + TcStage::kC + off, cm + lc * d.scl + cc, ok);
  }
#pragma unroll 1
  for (int i = tid; i < kTcQ * kPc; i += kTcThreads) {
    const int t = i / kPc, ch = i % kPc, l = c0 + t;
    const bool ok = t < d.q && l < d.L && ch * 8 < d.P;
    const long long lc = ok ? l : 0, cc = ok ? ch * 8 : 0;
    cp_async16(st + TcStage::kX + tile_chunk(t, ch, kRowP), x + lc * d.sxl + cc,
               ok);
  }
  const int t = tid % kTcQ, l = c0 + t;
  const bool ok = t < d.q && l < d.L;
  const long long lc = ok ? l : 0;
  if (tid < kTcQ)
    cp_async4(st + TcStage::kDt + 4 * t, dt + lc * d.sdl, ok);
  else
    cp_async4(st + TcStage::kLam + 4 * t, lam + lc * d.sll, ok);
}

// 2^x, one MUFU op (relative error about 2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Lambda = inclusive cumsum of the stage's lambda, in units of log2 (so
// that every exp below is one ex2), into cum; wdt[s] = exp(Lambda_last -
// Lambda_s) dt_s and, if given, ecum = exp(Lambda), all for this warp
// alone; returns Lambda_last (log2 units). Zero-filled steps leave Lambda
// flat, so Lambda_last is Lambda at the chunk's last real step.
__device__ __forceinline__ float tc_cumsum(const float* lam, const float* dt,
                                           float* cum, float* wdt,
                                           float* ecum, int lane) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float l0 = kLog2e * lam[2 * lane], l1 = kLog2e * lam[2 * lane + 1];
  float incl = l0 + l1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);  // shift, not subtract
  if (lane == 0) excl = 0.f;
  const float c0 = excl + l0, c1 = c0 + l1;
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  cum[2 * lane] = c0;
  cum[2 * lane + 1] = c1;
  wdt[2 * lane] = exp2_approx(last - c0) * dt[2 * lane];
  wdt[2 * lane + 1] = exp2_approx(last - c1) * dt[2 * lane + 1];
  if (ecum != nullptr) {
    ecum[2 * lane] = exp2_approx(c0);
    ecum[2 * lane + 1] = exp2_approx(c1);
  }
  __syncwarp();
  return last;
}

// NJ neighbouring 8-column tiles s = 8 j0 .. 8 (j0 + NJ) - 1 of G o dt in
// row tile m (rows t = 16m .. 16m + 15): (C B^T)[t, s] exp(Lambda_t -
// Lambda_s) dt_s for s <= t, 0 for s > t (masked before the exp: an inf * 0
// would poison the row), stored as hi/lo pairs (t, s) in gh/gl (8 chunks a
// row). The NJ accumulators take turns, so that no mma waits on the one
// before it.
template <typename T, int NJ>
__device__ __forceinline__ void tc_g_tiles(const unsigned char* bs,
                                           const unsigned char* cs,
                                           const float* dt, const float* cum,
                                           unsigned char* gh,
                                           unsigned char* gl, int m, int j0,
                                           int lane) {
  float acc[NJ][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jj][e] = 0.f;
#pragma unroll 1
  for (int kp = 0; kp < 4; ++kp) {            // two k-steps of 16 n
    uint32_t a[2][4], b[NJ][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      ldsm_x4<0>(a[h], cs + tile_chunk(16 * m + lane % 16,
                                      4 * kp + 2 * h + lane / 16, kRowN));
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      ldsm_x4<0>(b[jj], bs + tile_chunk(8 * (j0 + jj) + lane % 8,
                                       4 * kp + lane / 8, kRowN));
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      mma_16816(acc[jj], a[0], b[jj][0], b[jj][1], T{});
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      mma_16816(acc[jj], a[1], b[jj][2], b[jj][3], T{});
  }
  const int t0 = 16 * m + lane / 4, t1 = t0 + 8;
  const float ct0 = cum[t0], ct1 = cum[t1];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int s = 8 * (j0 + jj) + 2 * (lane % 4);
    const float e0 = dt[s], e1 = dt[s + 1], m0 = cum[s], m1 = cum[s + 1];
    const float v00 =
        s <= t0 ? acc[jj][0] * exp2_approx(ct0 - m0) * e0 : 0.f;
    const float v01 =
        s + 1 <= t0 ? acc[jj][1] * exp2_approx(ct0 - m1) * e1 : 0.f;
    const float v10 =
        s <= t1 ? acc[jj][2] * exp2_approx(ct1 - m0) * e0 : 0.f;
    const float v11 =
        s + 1 <= t1 ? acc[jj][3] * exp2_approx(ct1 - m1) * e1 : 0.f;
    uint32_t hi, lo;
    split_pair<T>(v00, v01, hi, lo);
    *reinterpret_cast<uint32_t*>(gh + tile_elem<2>(t0, s, kRowP)) = hi;
    *reinterpret_cast<uint32_t*>(gl + tile_elem<2>(t0, s, kRowP)) = lo;
    split_pair<T>(v10, v11, hi, lo);
    *reinterpret_cast<uint32_t*>(gh + tile_elem<2>(t1, s, kRowP)) = hi;
    *reinterpret_cast<uint32_t*>(gl + tile_elem<2>(t1, s, kRowP)) = lo;
  }
}

// G o dt on and below the diagonal: the 20 tiles (row tile m, 8-column
// tile j <= 2m + 1) shared five to a warp. Tiles above the diagonal are not
// written; the product that reads G stops at the diagonal.
template <typename T>
__device__ __forceinline__ void tc_masked_g(const unsigned char* bs,
                                            const unsigned char* cs,
                                            const float* dt, const float* cum,
                                            unsigned char* gh,
                                            unsigned char* gl, int warp,
                                            int lane) {
  switch (warp) {
    case 0:
      tc_g_tiles<T, 2>(bs, cs, dt, cum, gh, gl, 0, 0, lane);
      tc_g_tiles<T, 3>(bs, cs, dt, cum, gh, gl, 3, 5, lane);
      break;
    case 1:
      tc_g_tiles<T, 4>(bs, cs, dt, cum, gh, gl, 1, 0, lane);
      tc_g_tiles<T, 1>(bs, cs, dt, cum, gh, gl, 2, 5, lane);
      break;
    case 2:
      tc_g_tiles<T, 5>(bs, cs, dt, cum, gh, gl, 2, 0, lane);
      break;
    default:
      tc_g_tiles<T, 5>(bs, cs, dt, cum, gh, gl, 3, 0, lane);
      break;
  }
}

// A operands X^T of this warp's rows p, for the four k-steps of 16 s
__device__ __forceinline__ void tc_x_frags(const unsigned char* xs,
                                           uint32_t (&ax)[4][4], int warp,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4<1>(ax[kk], xs + tile_chunk(16 * kk + (lane / 16) * 8 + lane % 8,
                                      2 * warp + (lane / 8) % 2, kRowP));
}

// acc (rows p, 8 tiles of 8 columns t) += X^T (G o dt)^T, k = s stopping
// at each tile's diagonal; k-steps outermost, so that neighbouring mmas
// add into different accumulators
template <typename T>
__device__ __forceinline__ void tc_intra(const uint32_t (&ax)[4][4],
                                         const unsigned char* gh,
                                         const unsigned char* gl,
                                         float (&acc)[8][4], int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jp = kk; jp < 4; ++jp) {         // t tiles 2jp, 2jp + 1
      const int off = tile_chunk(16 * jp + (lane / 16) * 8 + lane % 8,
                                2 * kk + (lane / 8) % 2, kRowP);
      uint32_t bh[4], bl[4];
      ldsm_x4<0>(bh, gh + off);
      ldsm_x4<0>(bl, gl + off);
      mma_16816(acc[2 * jp], ax[kk], bh[0], bh[1], T{});
      mma_16816(acc[2 * jp + 1], ax[kk], bh[2], bh[3], T{});
      mma_16816(acc[2 * jp], ax[kk], bl[0], bl[1], T{});
      mma_16816(acc[2 * jp + 1], ax[kk], bl[2], bl[3], T{});
    }
}

// acc (rows p, 8 tiles of 8 columns t) += (sc H^T) C^T, sc H^T taken from
// the state accumulator hs (rows p, 16 tiles of 8 columns n) as hi/lo
// pairs: the A fragment of k-step kk is accumulator tiles 2kk and 2kk + 1
template <typename T>
__device__ __forceinline__ void tc_inter(const float (&hs)[16][4], float sc,
                                         const unsigned char* cs,
                                         float (&acc)[8][4], int lane) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    split_pair<T>(sc * hs[2 * kk][0], sc * hs[2 * kk][1], ah[0], al[0]);
    split_pair<T>(sc * hs[2 * kk][2], sc * hs[2 * kk][3], ah[1], al[1]);
    split_pair<T>(sc * hs[2 * kk + 1][0], sc * hs[2 * kk + 1][1], ah[2],
                  al[2]);
    split_pair<T>(sc * hs[2 * kk + 1][2], sc * hs[2 * kk + 1][3], ah[3],
                  al[3]);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4<0>(b, cs + tile_chunk(16 * jp + (lane / 16) * 8 + lane % 8,
                                   2 * kk + (lane / 8) % 2, kRowN));
      mma_16816(acc[2 * jp], ah, b[0], b[1], T{});
      mma_16816(acc[2 * jp + 1], ah, b[2], b[3], T{});
      mma_16816(acc[2 * jp], al, b[0], b[1], T{});
      mma_16816(acc[2 * jp + 1], al, b[2], b[3], T{});
    }
  }
}

// hs (rows p, 16 tiles of 8 columns n) += (X o w o dt)^T B. The A operand
// X^T comes from the X tile per k-step, each value scaled by wdt[s] and
// split into hi/lo in registers: this warp's rows p alone, half as many
// values as B o w o dt would have at P = 64, N = 128. B enters exactly,
// read transposed from the B tile. The mmas of neighbouring n tiles, which
// add into different accumulators, follow one another.
template <typename T>
__device__ __forceinline__ void tc_state(const unsigned char* xs,
                                         const unsigned char* bs,
                                         const float* wdt,
                                         float (&hs)[16][4], int warp,
                                         int lane) {
#pragma unroll 1
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ax[4], ah[4], al[4];
    ldsm_x4<1>(ax, xs + tile_chunk(16 * kk + (lane / 16) * 8 + lane % 8,
                                   2 * warp + (lane / 8) % 2, kRowP));
    // registers 0, 1 hold steps s, s + 1; registers 2, 3 steps s + 8, s + 9
    const int s = 16 * kk + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int sr = s + 8 * (r / 2);
      const T* v = reinterpret_cast<const T*>(&ax[r]);
      split_pair<T>(to_f32(v[0]) * wdt[sr], to_f32(v[1]) * wdt[sr + 1], ah[r],
                    al[r]);
    }
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {          // n tiles 2jn, 2jn + 1
      uint32_t b[4];
      ldsm_x4<1>(b, bs + tile_chunk(16 * kk + ((lane / 8) % 2) * 8 + lane % 8,
                                    2 * jn + lane / 16, kRowN));
      mma_16816(hs[2 * jn], ah, b[0], b[1], T{});
      mma_16816(hs[2 * jn + 1], ah, b[2], b[3], T{});
      mma_16816(hs[2 * jn], al, b[0], b[1], T{});
      mma_16816(hs[2 * jn + 1], al, b[2], b[3], T{});
    }
  }
}

// Dynamic shared memory of both tensor-core kernels: a two-stage ring of
// chunk tiles, the G tiles, the per-warp vectors.
constexpr int kTcSmem = 2 * TcStage::kBytes + kTcGBytes + kTcVecBytes;

// The chunk loop of both tensor-core kernels, one block of four warps.
//
// CARRY (ssd_scan.cu): the block walks the chunks of one (batch, head) in
// order, carrying H^T in registers; y goes out in T and the final state
// (B, H, P, N) at the end. !CARRY (matmul_scan.cu's local pass): the block
// walks items (batch, head, chunk) strided by the grid, each from a zero
// state, and writes y_local (B, L, H, P) and the chunk state S (B, H,
// nchunks, N, P) in f32. Either way cp.async loads the block's next chunk
// into the other stage of the ring while this one computes, and each
// chunk has two block-wide barriers: the stage has landed, and the G tiles
// are written. Each warp then stages its own rows p of y (and S) through
// columns of a tile that only it reads by then -- X (CARRY) or C -- and
// writes them as 16-byte rows of the model layout, so no other warp waits.
template <typename T, bool CARRY>
__device__ __forceinline__ void tc_chunk_loop(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ lam, const T* __restrict__ bm,
    const T* __restrict__ cm, void* __restrict__ yout,
    float* __restrict__ sout, const SsdDims& d, unsigned char* smem) {
  unsigned char* gh = smem + 2 * TcStage::kBytes;   // G o dt hi
  unsigned char* gl = gh + kTcGBytes / 2;           // G o dt lo
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* cum = reinterpret_cast<float*>(gh + kTcGBytes) + warp * kTcQ;
  float* wdt = cum + 4 * kTcQ;
  float* ecum = wdt + 4 * kTcQ;
  const int gq = lane / 4, cq = 2 * (lane % 4);     // fragment row, column
  const int nchunks = (d.L + d.q - 1) / d.q;
  const long long items = (long long)d.B * d.H * nchunks;
  const long long mine =
      CARRY ? nchunks : (items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  // (batch * H + head, chunk) of this block's k-th chunk
  auto item = [&](long long k, int& bh, int& chunk) {
    if (CARRY) {
      bh = blockIdx.x;
      chunk = (int)k;
    } else {
      const long long it = blockIdx.x + k * gridDim.x;
      bh = (int)(it / nchunks);
      chunk = (int)(it % nchunks);
    }
  };
  auto load = [&](long long k, unsigned char* st) {
    int bh, chunk;
    item(k, bh, chunk);
    const int bi = bh / d.H, h = bh % d.H, g = h / (d.H / d.G);
    tc_load_chunk<T>(x + bi * d.sxb + h * d.sxh, dt + bi * d.sdb + h * d.sdh,
                     lam + bi * d.slb + h * d.slh, bm + bi * d.sbb + g * d.sbg,
                     cm + bi * d.scb + g * d.scg, d, chunk * d.q, st, tid);
    cp_async_commit();
  };

  float hs[16][4];   // H^T or S^T: rows p = 16 warp + gq (+8), columns n
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) hs[j][e] = 0.f;

  if (mine > 0) load(0, smem);
  for (long long k = 0; k < mine; ++k) {
    unsigned char* st = smem + (k & 1) * TcStage::kBytes;
    int bh, chunk;
    item(k, bh, chunk);
    const int bi = bh / d.H, h = bh % d.H, c0 = chunk * d.q;
    cp_async_wait<0>();
    // chunk k has landed, and every warp is done with chunk k - 1, whose
    // stage the next load refills
    __syncthreads();
    if (k + 1 < mine) load(k + 1, smem + ((k + 1) & 1) * TcStage::kBytes);
    const float* dts = reinterpret_cast<const float*>(st + TcStage::kDt);
    const float last = tc_cumsum(
        reinterpret_cast<const float*>(st + TcStage::kLam), dts, cum, wdt,
        CARRY ? ecum : nullptr, lane);
    tc_masked_g<T>(st + TcStage::kB, st + TcStage::kC, dts, cum, gh, gl,
                   warp, lane);
    __syncthreads();

    float yo[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yo[j][e] = 0.f;
    if constexpr (CARRY) {
      // exp(Lambda_t) H^T C^T with H from before the chunk, its columns
      // scaled in registers; the intra-chunk product adds onto it
      float sc = 1.f, unsc = 1.f;
      if constexpr (std::is_same<T, __half>::value) {
        // a power of two per warp keeps the f16 pair of H below 2^14
        float m = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) m = fmaxf(m, fabsf(hs[j][e]));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        int ex;
        frexpf(m, &ex);
        ex = max(0, ex - 14);
        sc = ldexpf(1.f, -ex);
        unsc = ldexpf(1.f, ex);
      }
      tc_inter<T>(hs, sc, st + TcStage::kC, yo, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e0 = unsc * ecum[8 * j + cq];
        const float e1 = unsc * ecum[8 * j + cq + 1];
        yo[j][0] *= e0;
        yo[j][1] *= e1;
        yo[j][2] *= e0;
        yo[j][3] *= e1;
      }
      // H^T = exp(Lambda_last) H^T, then + the chunk's state below
      const float decay = exp2_approx(last);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[j][e] *= decay;
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) hs[j][e] = 0.f;
    }
    {
      uint32_t ax[4][4];
      tc_x_frags(st + TcStage::kX, ax, warp, lane);
      tc_intra<T>(ax, gh, gl, yo, lane);
    }
    tc_state<T>(st + TcStage::kX, st + TcStage::kB, wdt, hs, warp, lane);

    // y: this warp's rows p, through its own columns of a staging tile
    const int p0 = 16 * warp;
    __syncwarp();   // this warp's reads of the tile are done
    if constexpr (CARRY) {
      unsigned char* ys = st + TcStage::kX;   // this warp's X columns
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<T*>(ys + tile_elem<2>(8 * j + cq + (e & 1),
                                                  p0 + gq + 8 * (e >> 1),
                                                  kRowP)) =
              from_f32<T>(yo[j][e]);
      __syncwarp();
      T* y = static_cast<T*>(yout);
#pragma unroll
      for (int i = lane; i < 2 * kTcQ; i += 32) {   // 2 chunks a row
        const int t = i / 2, ch = 2 * warp + i % 2;
        const long long l = c0 + t;
        if (t < d.q && l < d.L && ch * 8 < d.P)
          *reinterpret_cast<uint4*>(y + ((bi * d.L + l) * d.H + h) * d.P +
                                    ch * 8) =
              *reinterpret_cast<const uint4*>(ys + tile_chunk(t, ch, kRowP));
      }
    } else {
      unsigned char* fs = st + TcStage::kC;   // free once G is written
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<float*>(fs + tile_elem<4>(8 * j + cq + (e & 1),
                                                      p0 + gq + 8 * (e >> 1),
                                                      kRowF)) = yo[j][e];
      __syncwarp();
      float* y = static_cast<float*>(yout);
#pragma unroll
      for (int i = lane; i < 4 * kTcQ; i += 32) {   // 4 chunks a row
        const int t = i / 4, ch = 4 * warp + i % 4;
        const long long l = c0 + t;
        if (t < d.q && l < d.L && ch * 4 < d.P)
          *reinterpret_cast<float4*>(y + ((bi * d.L + l) * d.H + h) * d.P +
                                     ch * 4) =
              *reinterpret_cast<const float4*>(fs + tile_chunk(t, ch, kRowF));
      }
      // S = (S^T)^T, (N, P) f32, through the same columns, 64 rows n at a
      // time
      float* sc = sout + ((long long)bh * nchunks + chunk) * d.N * d.P;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<float*>(
                fs + tile_elem<4>(8 * j + cq + (e & 1),
                                  p0 + gq + 8 * (e >> 1), kRowF)) =
                hs[8 * half + j][e];
        __syncwarp();
#pragma unroll
        for (int i = lane; i < 4 * kTcQ; i += 32) {
          const int r = i / 4, ch = 4 * warp + i % 4, n = 64 * half + r;
          if (n < d.N && ch * 4 < d.P)
            *reinterpret_cast<float4*>(sc + n * d.P + ch * 4) =
                *reinterpret_cast<const float4*>(fs +
                                                 tile_chunk(r, ch, kRowF));
        }
      }
    }
  }

  if constexpr (CARRY) {
    // the final state (B, H, P, N) from the registers
    const long long bh = blockIdx.x;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * warp + gq + 8 * r, n = 8 * j + cq;
        if (p < d.P && n < d.N)
          *reinterpret_cast<float2*>(sout + (bh * d.P + p) * d.N + n) =
              make_float2(hs[j][2 * r], hs[j][2 * r + 1]);
      }
  }
}

}  // namespace rt
