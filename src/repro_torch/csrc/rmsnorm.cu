// Row RMSNorm: out = x * rsqrt(mean(x^2) + eps) * w, in x's dtype.
//
// Replaces src/repro/kernels/fused_rmsnorm.py::fused_rmsnorm (and its
// Pallas-Triton twin src/repro/kernels/triton/fused_rmsnorm.py::
// triton_fused_rmsnorm). The TPU kernel sums x^2 as the matmul (x o x) @ 1;
// a row of d values is too little work for a tensor-core fragment to pay
// off here, so the sum is a warp-shuffle reduction in f32.
//
// Bound on an H100: bytes. One read of x and one write of the output; a
// handful of operations per element.
//
// Design: one warp per row, any d. Pass 1 accumulates the f32 sum of squares
// with 16-byte loads where d and the pointers allow and reduces it across
// the warp with shuffles; pass 2 reads the row again (an L1/L2 hit at model
// widths) and writes the normalised values. The weight is either x's dtype
// or f32.
#include "common.cuh"

namespace rt {

constexpr int kRowsPerBlock = 8;

template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
                   T* __restrict__ out, long long rows, int d, float eps) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // whole warp: row is uniform across it
  const T* xr = x + row * d;
  T* orow = out + row * d;
  constexpr int V = 16 / sizeof(T);

  float ss = 0.f;
  if constexpr (VEC) {
    for (int i = lane * V; i < d; i += 32 * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f32(v[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / d + eps);

  if constexpr (VEC) {
    for (int i = lane * V; i < d; i += 32 * V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + i);
      const T* v = reinterpret_cast<const T*>(&raw);
      uint4 packed;
      T* o = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = from_f32<T>(to_f32(v[j]) * r * to_f32(w[i + j]));
      *reinterpret_cast<uint4*>(orow + i) = packed;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
  }
}

template <typename T, typename W>
static int launch(const void* x, const void* w, void* out, long long rows,
                  int d, float eps, cudaStream_t stream) {
  const unsigned blocks =
      (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* op = static_cast<T*>(out);
  if (d % (16 / sizeof(T)) == 0 && aligned16(x) && aligned16(out))
    rmsnorm_kernel<T, W, true>
        <<<blocks, kRowsPerBlock * 32, 0, stream>>>(xp, wp, op, rows, d, eps);
  else
    rmsnorm_kernel<T, W, false>
        <<<blocks, kRowsPerBlock * 32, 0, stream>>>(xp, wp, op, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_w(const void* x, const void* w, int w_f32, void* out,
                    long long rows, int d, float eps, cudaStream_t stream) {
  return w_f32 ? launch<T, float>(x, w, out, rows, d, eps, stream)
               : launch<T, T>(x, w, out, rows, d, eps, stream);
}

}  // namespace rt

// x, out: (rows, d) contiguous with the dtype code; w: (d,) in that dtype,
// or f32 when w_f32 is set.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              long long rows, int d, int dtype, int w_f32,
                              float eps, void* stream) {
  if (rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return rt::launch<float, float>(x, w, out, rows, d, eps, st);
    case rt::kF16:
      return rt::launch_w<__half>(x, w, w_f32, out, rows, d, eps, st);
    case rt::kBF16:
      return rt::launch_w<__nv_bfloat16>(x, w, w_f32, out, rows, d, eps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
