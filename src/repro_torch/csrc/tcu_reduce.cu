// Segmented reduction on tensor cores: the paper's Algorithm 3.
//
// Replaces src/repro/kernels/tcu_reduce.py::tcu_segmented_reduce_tn (and
// its Pallas-Triton twin src/repro/kernels/triton/tcu_reduce.py::
// triton_segmented_reduce): out[r] = sum_k x[r, k], f32 accumulation.
//
// Bound on an H100: bytes. Each element is read once and used for one
// addition, far below the ~295 operations per byte at which the tensor
// cores become the limit, so the floor is the input size over 3.35 TB/s.
//
// Design: the input stays in the model layout (rows, n); no transpose. A
// warp owns 16 segments and walks n in 16-wide tiles, each tile doing
// acc += A_tile @ ones on a 16x16x16 wmma fragment (the work-efficient
// V_i = A_i . 1 + V_{i-1}, collapsed once at the end: column 0 of acc holds
// the row sums). Ragged edges in n and in rows are zero-filled in shared
// memory. When there are too few 16-row groups to fill the card, up to 8
// warps of a block split one group's columns and their partial sums are
// added through shared memory. f32 input goes through the three-part bf16
// split of tcu_tile.cuh. Loads are 16 bytes per lane where n allows.
#include "tcu_tile.cuh"

namespace rt {

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    tcu_reduce_kernel(const T* __restrict__ x, float* __restrict__ out,
                      long long rows, long long n, int wpg) {
  using FT = typename Operand<T>::type;
  __shared__ __align__(32) FT stage_s[kWarps][Operand<T>::parts * kPlane];
  __shared__ __align__(32) float acc_s[kWarps][kTile * kTile];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = kWarps / wpg, g = warp / wpg, part = warp % wpg;
  const long long row0 = ((long long)blockIdx.x * groups + g) * kTile;

  FragB<FT> ones;
  wmma::fill_fragment(ones, from_f32<FT>(1.f));
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
  if (row0 < rows) {
    for (long long col0 = (long long)part * kCols; col0 < n;
         col0 += (long long)wpg * kCols) {
      stage<T, VEC>(x, rows, n, n, row0, col0, stage_s[warp], lane);
      __syncwarp();
      mma_staged<T>(acc, stage_s[warp], 0, ones);
      mma_staged<T>(acc, stage_s[warp], 1, ones);
      __syncwarp();
    }
  }
  wmma::store_matrix_sync(acc_s[warp], acc, kTile, wmma::mem_row_major);
  __syncthreads();
  if (part == 0 && lane < kTile && row0 + lane < rows) {
    float s = 0.f;
    for (int p = 0; p < wpg; ++p) s += acc_s[warp + p][lane * kTile];
    out[row0 + lane] = s;
  }
}

template <typename T>
static int launch(const void* x, void* out, long long rows, long long n,
                  cudaStream_t stream) {
  const int wpg = warps_per_group(rows, n);
  const long long per_block = (long long)(kWarps / wpg) * kTile;
  const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
  const T* xp = static_cast<const T*>(x);
  float* op = static_cast<float*>(out);
  if (vec_ok(x, n, sizeof(T)))
    tcu_reduce_kernel<T, true>
        <<<blocks, kWarps * 32, 0, stream>>>(xp, op, rows, n, wpg);
  else
    tcu_reduce_kernel<T, false>
        <<<blocks, kWarps * 32, 0, stream>>>(xp, op, rows, n, wpg);
  return (int)cudaGetLastError();
}

}  // namespace rt

// x: (rows, n) contiguous, dtype code; out: (rows,) f32.
extern "C" int tcu_reduce_launch(const void* x, void* out, long long rows,
                                 long long n, int dtype, void* stream) {
  if (rows < 1 || n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32: return rt::launch<float>(x, out, rows, n, st);
    case rt::kF16: return rt::launch<__half>(x, out, rows, n, st);
    case rt::kBF16: return rt::launch<__nv_bfloat16>(x, out, rows, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
