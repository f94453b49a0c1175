// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, in x's dtype.
//
// Replaces src/repro/kernels/fused_rmsnorm.py::fused_rmsnorm (and its
// Pallas-Triton twin src/repro/kernels/triton/fused_rmsnorm.py::
// triton_fused_rmsnorm). The TPU kernel sums x^2 as the matmul (x o x) @ 1;
// a row of d values is too little work for a tensor-core fragment to pay
// off here, so the sum is a shuffle reduction in f32.
//
// Bound on an H100: bytes at prefill (one read of x, one write of the
// output, a handful of operations per element); latency at decode, where a
// step normalises 4 rows of 2048 or 4096 values.
//
// Design: x is read once. Each thread holds its part of the row in
// registers, VPT <= 8 16-byte vectors (a compile-time count; at 16 ptxas
// spills), and the matching
// vectors of w (16 bytes, or 32 when w is f32), all loaded before the
// reduction so that they are in flight together; it then writes its
// normalised vectors. The caller chooses the threads per row
// (kernels/layout.py, from the row count): a warp per row when there are
// many rows, reduced with shuffles; a block per row when there are few, so
// that 4 decode rows run on 4 SMs, reduced with shuffles and then across
// the row's warps in shared memory. A row longer than 8 vectors for each
// of a block's 256 threads (bf16 d > 16384) is streamed twice instead.
// Vectors need d a multiple of 16 bytes' worth of elements and 16-byte
// aligned pointers; otherwise each vector is loaded element by element,
// zero past d.
#include "common.cuh"

namespace rt {

constexpr int kRmsMaxVpt = 8;    // 16-byte vectors a thread holds
constexpr int kRmsBlock = 256;   // threads of a block; rows share it

template <typename E, int N>
struct alignas(16) Vec {
  E e[N];
};

// vector vi of a row; VEC: whole vectors, else element by element
template <typename E, int N, bool VEC>
__device__ __forceinline__ Vec<E, N> load_vec(const E* __restrict__ p,
                                              int vi, int d) {
  if constexpr (VEC) {
    return reinterpret_cast<const Vec<E, N>*>(p)[vi];
  } else {
    Vec<E, N> r;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = vi * N + j;
      r.e[j] = i < d ? p[i] : from_f32<E>(0.f);
    }
    return r;
  }
}

template <typename E, int N, bool VEC>
__device__ __forceinline__ void store_vec(E* __restrict__ p, int vi, int d,
                                          const Vec<E, N>& v) {
  if constexpr (VEC) {
    reinterpret_cast<Vec<E, N>*>(p)[vi] = v;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (vi * N + j < d) p[vi * N + j] = v.e[j];
  }
}

template <typename T, typename W, int V>
__device__ __forceinline__ Vec<T, V> normalise(const Vec<T, V>& x,
                                               const Vec<W, V>& w, float r) {
  Vec<T, V> o;
#pragma unroll
  for (int j = 0; j < V; ++j)
    o.e[j] = from_f32<T>(to_f32(x.e[j]) * r * to_f32(w.e[j]));
  return o;
}

// Sum of ss over the tpr threads of each row. Every thread of the block
// calls it once (tpr is uniform over the block).
__device__ __forceinline__ float row_sum(float ss, int tpr, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {
    const int warp = threadIdx.x / 32, wpr = tpr / 32;
    if (threadIdx.x % 32 == 0) red[warp] = ss;
    __syncthreads();
    const int first = (warp / wpr) * wpr;
    ss = 0.f;
    for (int i = 0; i < wpr; ++i) ss += red[first + i];
  }
  return ss;
}

template <typename T, typename W, int VPT, bool VEC>
__global__ void __launch_bounds__(kRmsBlock)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ out, long long rows, int d, int tpr,
                   float eps) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float red[32];
  const int t = threadIdx.x % tpr;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool active = row < rows;  // idle threads still reach the barrier
  const int nvec = (d + V - 1) / V;
  const T* xr = x + (active ? row : 0) * d;
  T* orow = out + (active ? row : 0) * d;

  if (nvec <= VPT * tpr) {
    Vec<T, V> xv[VPT];
    Vec<W, V> wv[VPT];
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int vi = t + k * tpr;
      if (active && vi < nvec) {
        xv[k] = load_vec<T, V, VEC>(xr, vi, d);
        wv[k] = load_vec<W, V, VEC>(w, vi, d);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          xv[k].e[j] = from_f32<T>(0.f);
          wv[k].e[j] = from_f32<W>(0.f);
        }
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(xv[k].e[j]);
        ss += f * f;
      }
    const float r = rsqrtf(row_sum(ss, tpr, red) / d + eps);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int vi = t + k * tpr;
      if (active && vi < nvec)
        store_vec<T, V, VEC>(orow, vi, d, normalise(xv[k], wv[k], r));
    }
  } else {
    // longer than the registers hold: sum, then read again and write
    float ss = 0.f;
    for (int vi = t; active && vi < nvec; vi += tpr) {
      const Vec<T, V> xv = load_vec<T, V, VEC>(xr, vi, d);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(xv.e[j]);
        ss += f * f;
      }
    }
    const float r = rsqrtf(row_sum(ss, tpr, red) / d + eps);
    for (int vi = t; active && vi < nvec; vi += tpr)
      store_vec<T, V, VEC>(orow, vi, d,
                           normalise(load_vec<T, V, VEC>(xr, vi, d),
                                     load_vec<W, V, VEC>(w, vi, d), r));
  }
}

template <typename T, typename W, bool VEC>
static int launch_vec(const void* x, const void* w, void* out,
                      long long rows, int d, int tpr, float eps,
                      cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = (d + V - 1) / V;
  const int need = (nvec + tpr - 1) / tpr;  // vectors per thread
  const int per_block = kRmsBlock / tpr;
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  auto kern = need <= 1   ? rmsnorm_kernel<T, W, 1, VEC>
              : need <= 2 ? rmsnorm_kernel<T, W, 2, VEC>
              : need <= 4 ? rmsnorm_kernel<T, W, 4, VEC>
                          : rmsnorm_kernel<T, W, kRmsMaxVpt, VEC>;
  kern<<<(unsigned)blocks, kRmsBlock, 0, stream>>>(xp, wp, op, rows, d,
                                                   tpr, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
static int launch(const void* x, const void* w, void* out, long long rows,
                  int d, int tpr, float eps, cudaStream_t stream) {
  const bool vec = d % (16 / sizeof(T)) == 0 && aligned16(x) &&
                   aligned16(w) && aligned16(out);
  return vec ? launch_vec<T, W, true>(x, w, out, rows, d, tpr, eps, stream)
             : launch_vec<T, W, false>(x, w, out, rows, d, tpr, eps, stream);
}

template <typename T>
static int launch_w(const void* x, const void* w, int w_f32, void* out,
                    long long rows, int d, int tpr, float eps,
                    cudaStream_t stream) {
  return w_f32 ? launch<T, float>(x, w, out, rows, d, tpr, eps, stream)
               : launch<T, T>(x, w, out, rows, d, tpr, eps, stream);
}

}  // namespace rt

// x, out: (rows, d) contiguous with the dtype code; w: (d,) in that dtype,
// or f32 when w_f32 is set. threads_per_row: a power of two from 32 to
// 256 (kernels/layout.py::rmsnorm_threads chooses it).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              long long rows, int d, int dtype, int w_f32,
                              float eps, int threads_per_row, void* stream) {
  const int tpr = threads_per_row;
  if (rows < 1 || d < 1 || tpr < 32 || tpr > rt::kRmsBlock || (tpr & (tpr - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return rt::launch<float, float>(x, w, out, rows, d, tpr, eps, st);
    case rt::kF16:
      return rt::launch_w<__half>(x, w, w_f32, out, rows, d, tpr, eps, st);
    case rt::kBF16:
      return rt::launch_w<__nv_bfloat16>(x, w, w_f32, out, rows, d, tpr, eps,
                                         st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
