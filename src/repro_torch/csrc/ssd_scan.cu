// Mamba-2 SSD chunk scan: the paper's scan generalised to decayed weights.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_chunk_scan (and its
// Pallas-Triton twin src/repro/kernels/triton/ssd_scan.py::
// triton_ssd_chunk_scan). Per (batch, head) and chunk of q steps:
//   Lambda = cumsum(lambda)                       (in-block warp scan)
//   y      = ((C B^T) o exp(Lambda_t - Lambda_s)) (dt o X)   intra-chunk
//          + (C o exp(Lambda)) H                            inter-chunk
//   H      = exp(Lambda_last) H + (B o exp(Lambda_last - Lambda))^T (dt o X)
// with lambda = dt * a, state H (N, P) carried across chunks.
//
// Bound on an H100: bytes at the model's shapes (B=4, L=512, H=64, P=64,
// N=128: about 7 GFLOP of chunked products against about 50 MB of traffic,
// so the tensor-core floor is below the memory floor). This first version
// does the four products as f32 FMA loops on the CUDA cores, so in practice
// it is bound by those loops; wmma/wgmma for the products is later work.
//
// Design: one thread block per (batch, head). The TPU kernel's sequential
// grid axis over chunks becomes a loop inside the block, and H stays in
// shared memory across chunks. At q = 64, N = 128, P = 64 the chunk's B^T,
// C, dt.X, the q x q masked C B^T and H take about 128 KB of shared memory,
// above the 48 KB static limit, so it is dynamic shared memory raised with
// cudaFuncSetAttribute. Each product gives every thread a 4x4 register tile
// whose column operand is read as float4 from a [k][col] array. The mask
// tau > t is applied before the exp (the TPU code exponentiates everywhere
// and masks afterwards; here an inf * 0 would poison the row). B and C are
// read by group index h / (H / G) instead of being repeated per head, x is
// read in the model layout through strides, and y and the final state are
// written in the model layout (B, L, H, P) and (B, H, P, N). Steps past L in
// the last chunk load lambda = 0, x = 0, b = c = 0, which leaves H exact.
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

inline size_t ssd_smem_bytes(int q, int P, int N) {
  const size_t pp = round4(P), np = round4(N);
  return sizeof(float) *
         (np * pp + 2 * np * q + (size_t)q * pp + (size_t)q * q + 2 * q);
}

// Inclusive scan of cum[0:q) in place by one warp, then
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
  const float last = cum[q - 1];
  for (int t = lane; t < q; t += 32) wv[t] = expf(last - cum[t]);
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ lam, const T* __restrict__ bm,
                    const T* __restrict__ cm, T* __restrict__ y,
                    float* __restrict__ state, SsdDims d) {
  extern __shared__ __align__(16) float smem[];
  const int q = d.q, pp = round4(d.P), np = round4(d.N);
  float* hs = smem;              // (np, pp)  state H[n][p]
  float* bt = hs + np * pp;      // (np, q)   B^T of the chunk
  float* cs = bt + np * q;       // (q, np)   C of the chunk
  float* xs = cs + q * np;       // (q, pp)   dt * x
  float* gs = xs + q * pp;       // (q, q)    masked C B^T
  float* cum = gs + q * q;       // (q)       Lambda
  float* wv = cum + q;           // (q)       exp(Lambda_last - Lambda)

  const int bh = blockIdx.x, bi = bh / d.H, h = bh % d.H;
  const int g = h / (d.H / d.G);
  const int tid = threadIdx.x;
  const int nt = q / 4, ntp = pp / 4, ntn = np / 4;

  for (int i = tid; i < np * pp; i += kSsdThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < d.L; c0 += q) {
    __syncthreads();  // previous chunk is done with the staged arrays
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
    __syncthreads();
    if (tid < 32) chunk_cumsum(cum, wv, q, tid);
    __syncthreads();

    // G = (C B^T) o exp(Lambda_t - Lambda_s), zero above the diagonal
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
    __syncthreads();

    // y = G (dt o X) + exp(Lambda) (C H), with H from before this chunk
    for (int tile = tid; tile < nt * ntp; tile += kSsdThreads) {
      const int t0 = (tile / ntp) * 4, p0 = (tile % ntp) * 4;
      float yi[4][4] = {}, yo[4][4] = {};
      for (int k = 0; k < t0 + 4; ++k) {  // G is zero for k > t
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
      for (int k = 0; k < np; ++k) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + k * pp + p0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cv = cs[(t0 + i) * np + k];
          yo[i][0] += cv * hv.x;
          yo[i][1] += cv * hv.y;
          yo[i][2] += cv * hv.z;
          yo[i][3] += cv * hv.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = c0 + t0 + i;
        if (l >= d.L) continue;
        const float e = expf(cum[t0 + i]);
        T* yrow = y + (((long long)bi * d.L + l) * d.H + h) * d.P;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (p0 + j < d.P)
            yrow[p0 + j] = from_f32<T>(yi[i][j] + e * yo[i][j]);
      }
    }
    __syncthreads();

    // H = exp(Lambda_last) H + (B o w)^T (dt o X)
    const float decay = expf(cum[q - 1]);
    for (int tile = tid; tile < ntn * ntp; tile += kSsdThreads) {
      const int n0 = (tile / ntp) * 4, p0 = (tile % ntp) * 4;
      float acc[4][4] = {};
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
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& hv = hs[(n0 + i) * pp + p0 + j];
          hv = decay * hv + acc[i][j];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < d.P * d.N; i += kSsdThreads) {
    const int p = i / d.N, n = i % d.N;
    state[((long long)bh * d.P + p) * d.N + n] = hs[n * pp + p];
  }
}

template <typename T>
static int launch(const void* x, const void* dt, const void* lam,
                  const void* b, const void* c, void* y, void* state,
                  const SsdDims& d, cudaStream_t stream) {
  const size_t smem = ssd_smem_bytes(d.q, d.P, d.N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<d.B * d.H, kSsdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(lam), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(state), d);
  return (int)cudaGetLastError();
}

}  // namespace rt

// Dynamic shared memory the kernel needs at chunk q (bytes).
extern "C" long long ssd_scan_smem_bytes(int q, int P, int N) {
  return (long long)rt::ssd_smem_bytes(q, P, N);
}

// x, b, c and y share the dtype code; dt, lam f32; y (B, L, H, P) and state
// (B, H, P, N) f32 contiguous. q must be a multiple of 16 and H of G.
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* lam, const void* b,
    const void* c, void* y, void* state, int dtype, int B, int L, int H,
    int G, int P, int N, int q, long long sxb, long long sxl, long long sxh,
    long long sdb, long long sdl, long long sdh, long long slb,
    long long sll, long long slh, long long sbb, long long sbl,
    long long sbg, long long scb, long long scl, long long scg,
    void* stream) {
  if (B < 1 || L < 1 || H < 1 || G < 1 || H % G || P < 1 || N < 1 ||
      q < 16 || q % 16)
    return (int)cudaErrorInvalidValue;
  const rt::SsdDims d{B,   L,   H,   G,   P,   N,   q,   sxb, sxl, sxh, sdb,
                      sdl, sdh, slb, sll, slh, sbb, sbl, sbg, scb, scl, scg};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return rt::launch<float>(x, dt, lam, b, c, y, state, d, st);
    case rt::kF16:
      return rt::launch<__half>(x, dt, lam, b, c, y, state, d, st);
    case rt::kBF16:
      return rt::launch<__nv_bfloat16>(x, dt, lam, b, c, y, state, d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
