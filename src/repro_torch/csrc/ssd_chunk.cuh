// The chunk body shared by ssd_scan.cu (state carried across chunks) and
// matmul_scan.cu's local SSD pass (no carry): the staged chunk, its
// cumulative log decay, the masked C B^T block and the chunk's state
// product. Every product gives a thread a 4x4 register tile whose column
// operand is read as float4 from a [k][col] array in shared memory.
#pragma once

#include "common.cuh"

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
// bt = B^T (np, q), cs = C (q, np), xs = dt * x (q, pp), cum = lambda (q).
// Steps past L and the padding columns past N and P are zero, which leaves
// every product of the chunk exact.
template <typename T>
__device__ __forceinline__ void stage_chunk(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ lam, const T* __restrict__ bm,
    const T* __restrict__ cm, const SsdDims& d, int bi, int h, int g,
    int c0, float* bt, float* cs, float* xs, float* cum, int tid) {
  const int q = d.q, pp = round4(d.P), np = round4(d.N);
  for (int i = tid; i < q * np; i += kSsdThreads) {
    const int t = i / np, n = i % np, l = c0 + t;
    const bool ok = l < d.L && n < d.N;
    bt[n * q + t] =
        ok ? to_f32(bm[bi * d.sbb + l * d.sbl + g * d.sbg + n]) : 0.f;
    cs[i] = ok ? to_f32(cm[bi * d.scb + l * d.scl + g * d.scg + n]) : 0.f;
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
  const int nt = q / 4;
  for (int tile = tid; tile < nt * nt; tile += kSsdThreads) {
    const int t0 = (tile / nt) * 4, s0 = (tile % nt) * 4;
    float acc[4][4] = {};
    if (s0 <= t0 + 3) {
      for (int k = 0; k < np; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(bt + k * q + s0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = cs[(t0 + i) * np + k];
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
  for (int k = 0; k < q; ++k) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + k * pp + p0);
    const float w = wv[k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float bv = bt[(n0 + i) * q + k] * w;
      acc[i][0] += bv * xv.x;
      acc[i][1] += bv * xv.y;
      acc[i][2] += bv * xv.z;
      acc[i][3] += bv * xv.w;
    }
  }
}

}  // namespace rt
