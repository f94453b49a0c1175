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
// N=128: about 6 GFLOP of chunked products, doubled by the hi/lo operand
// pairs, against about 43 MB of traffic, 13 us at 3.35 TB/s). What bounds
// it in practice is the serial chain: each (batch, head) walks its chunks
// in order, the TPU kernel's sequential grid axis, and a chunk's four
// dependent products, its splits into hi/lo pairs, its loads and its two
// barriers run on four warps; with only two chains per SM at the served
// shape, their latency is the limit, not the tensor pipe (PERF.md).
//
// f16 / bf16 (the served types; ssd_chunk.cuh's ssd_mma_fits): one block of
// four warps per (batch, head) running ssd_chunk.cuh's tc_chunk_loop with
// the carry, 108 KB of shared memory, so that two blocks share an SM and
// the 256 chains of the served shape run in one wave of the 132 SMs. Per
// chunk the four products run on the tensor cores (mma.sync m16n8k16),
// while cp.async loads the next chunk's B, C, X, dt and lambda into the
// other stage of a two-stage ring. The state H stays in f32 registers for
// the whole chain, transposed (P x N) as the warps' mma accumulators, and
// enters C H as their A operand; the decay mask, the row scale
// exp(Lambda_t) and the chunk decay are applied to accumulators in
// registers. Each warp writes its rows p of y through its own columns of
// the consumed X tile as 16-byte rows of the model layout; the final state
// is written from the registers at the end. wgmma was not used: its B
// operand is read from shared memory, where the three f32 operands formed
// in the kernel would have to be written as hi/lo tiles first; mma.sync
// splits them in registers.
//
// f32 and every other shape: the first version's design. One block of 256
// threads per (batch, head); the chunk's B^T, C, dt.X, the q x q masked
// C B^T and H in about 130 KB of f32 shared memory; each product gives
// every thread a 4x4 register tile whose column operand is read as float4
// from a [k][col] array. (The weighted scan has its own kernel,
// weighted_scan.cu.)
//
// Both: the mask s > t is applied before the exp (the TPU code
// exponentiates everywhere and masks afterwards; here an inf * 0 would
// poison the row). B and C are read by group index h / (H / G) instead of
// being repeated per head, x is read in the model layout through strides,
// and y and the final state are written in the model layout (B, L, H, P)
// and (B, H, P, N). Steps past L in the last chunk load lambda = 0, x = 0,
// b = c = 0, which leaves H exact.
#include <type_traits>

#include "ssd_chunk.cuh"

namespace rt {

// ---------------------------------------------------------------------------
// f32 and other shapes: FMA loops

inline size_t ssd_smem_bytes(int q, int P, int N) {
  const size_t pp = round4(P), np = round4(N);
  return sizeof(float) * (np * pp + np * (size_t)bt_stride(q) +
                          (size_t)q * cs_stride(np) + (size_t)q * pp +
                          (size_t)q * q + 2 * q);
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
  float* cs = bt + np * bt_stride(q);  // (q, np)   C of the chunk
  float* xs = cs + q * cs_stride(np);  // (q, pp)   dt * x
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
    stage_chunk<T>(x, dt, lam, bm, cm, d, bi, h, g, c0, bt, cs, xs, cum,
                   tid);
    __syncthreads();
    if (tid < 32) chunk_cumsum(cum, wv, q, tid);
    __syncthreads();

    // G = (C B^T) o exp(Lambda_t - Lambda_s), zero above the diagonal
    masked_cb(bt, cs, cum, gs, q, np, tid);
    __syncthreads();

    // y = G (dt o X) + exp(Lambda) (C H), with H from before this chunk
    for (int tile = tid; tile < nt * ntp; tile += kSsdThreads) {
      const int t0 = (tile / ntp) * 4, p0 = (tile % ntp) * 4;
      float yi[4][4] = {}, yo[4][4] = {};
      intra_tile(gs, xs, q, pp, t0, p0, yi);
      for (int k = 0; k < np; ++k) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + k * pp + p0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cv = cs[(t0 + i) * cs_stride(np) + k];
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
      state_tile(bt, xs, wv, q, pp, n0, p0, acc);
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

// ---------------------------------------------------------------------------
// f16 / bf16: tensor cores, a two-stage cp.async ring

template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
    ssd_scan_mma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                        const float* __restrict__ lam,
                        const T* __restrict__ bm, const T* __restrict__ cm,
                        T* __restrict__ y, float* __restrict__ state,
                        SsdDims d) {
  extern __shared__ __align__(128) unsigned char sc_raw[];
  tc_chunk_loop<T, true>(x, dt, lam, bm, cm, y, state, d, sc_raw);
}

template <typename T>
static int launch_mma(const void* x, const void* dt, const void* lam,
                      const void* b, const void* c, void* y, void* state,
                      const SsdDims& d, cudaStream_t stream) {
  if (!tc_rows_aligned(x, b, c, d)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTcSmem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_mma_kernel<T><<<d.B * d.H, kTcThreads, kTcSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(lam), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(state), d);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* x, const void* dt, const void* lam,
                  const void* b, const void* c, void* y, void* state,
                  const SsdDims& d, int dtype, cudaStream_t stream) {
  if constexpr (!std::is_same<T, float>::value) {
    if (ssd_mma_fits(dtype, d.q, d.P, d.N))
      return launch_mma<T>(x, dt, lam, b, c, y, state, d, stream);
  }
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

// Dynamic shared memory the FMA instance needs at chunk q (bytes).
extern "C" long long ssd_scan_smem_bytes(int q, int P, int N) {
  return (long long)rt::ssd_smem_bytes(q, P, N);
}

// 1 when ssd_scan_launch and matmul_local_ssd_launch run the tensor-core
// instance for this dtype code and shape, 0 when they run the FMA instance.
extern "C" int ssd_uses_mma(int dtype, int q, int P, int N) {
  return rt::ssd_mma_fits(dtype, q, P, N) ? 1 : 0;
}

// x, b, c and y share the dtype code; dt, lam f32; y (B, L, H, P) and state
// (B, H, P, N) f32 contiguous. q must be a multiple of 16 and H of G. The
// tensor-core instance (ssd_uses_mma) also needs 16-byte aligned x, b, c
// and strides that are multiples of 8 elements.
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
      return rt::launch<float>(x, dt, lam, b, c, y, state, d, dtype, st);
    case rt::kF16:
      return rt::launch<__half>(x, dt, lam, b, c, y, state, d, dtype, st);
    case rt::kBF16:
      return rt::launch<__nv_bfloat16>(x, dt, lam, b, c, y, state, d, dtype,
                                       st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
