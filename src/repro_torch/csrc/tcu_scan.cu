// Segmented inclusive scan on tensor cores: the paper's A @ U with a carry.
//
// Replaces src/repro/kernels/tcu_scan.py::tcu_segmented_scan_tn (and its
// Pallas-Triton twin src/repro/kernels/triton/tcu_scan.py::
// triton_segmented_scan): out[r, j] = sum_{k <= j} x[r, k] in f32.
//
// Bound on an H100: bytes. One read of the input and one f32 write of the
// output; the arithmetic is one addition per element.
//
// Design: a warp owns 16 segments and walks n in 16-wide tiles. Each tile is
// staged in shared memory (zero-filled edges) and multiplied by U, the 16x16
// upper-triangular ones matrix, on a wmma fragment: a row-wise inclusive
// scan. The paper's Broadcast(LastColumn(R)) carry becomes a per-row running
// sum in shared memory, added as the tile is written out and then advanced
// by the tile's last column. When there are too few 16-row groups to fill
// the card, up to 8 warps split a group's columns into contiguous ranges:
// each first reduces its range (A @ ones), the partial totals give each
// warp its starting carry, and then every range is scanned in parallel.
// f32 input goes through the three-part bf16 split of tcu_tile.cuh. The
// exclusive scan is made by a shift in the Python glue, never here as
// inclusive - x.
#include "tcu_tile.cuh"

namespace rt {

template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    tcu_scan_kernel(const T* __restrict__ x, float* __restrict__ out,
                    long long rows, long long n, int wpg, long long span) {
  using FT = typename Operand<T>::type;
  __shared__ __align__(32) FT stage_s[kWarps][Operand<T>::parts * kPlane];
  __shared__ __align__(32) float tile_s[kWarps][kTile * kTile];
  __shared__ __align__(32) FT u_s[kTile * kTile];
  __shared__ float total_s[kWarps][kTile];
  __shared__ float carry_s[kWarps][kTile];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = kWarps / wpg, g = warp / wpg, part = warp % wpg;
  const long long row0 = ((long long)blockIdx.x * groups + g) * kTile;
  const long long lo = (long long)part * span;
  const long long hi = lo + span < n ? lo + span : n;
  const bool live = row0 < rows;

  for (int i = threadIdx.x; i < kTile * kTile; i += blockDim.x)
    u_s[i] = from_f32<FT>((i / kTile) <= (i % kTile) ? 1.f : 0.f);
  __syncthreads();

  if (lane < kTile) carry_s[warp][lane] = 0.f;
  if (wpg > 1) {
    // phase 1: each warp's range total per row, then the starting carries
    FragB<FT> ones;
    wmma::fill_fragment(ones, from_f32<FT>(1.f));
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    if (live) {
      for (long long col0 = lo; col0 < hi; col0 += kCols) {
        stage<T, VEC>(x, rows, n, hi, row0, col0, stage_s[warp], lane);
        __syncwarp();
        mma_staged<T>(acc, stage_s[warp], 0, ones);
        mma_staged<T>(acc, stage_s[warp], 1, ones);
        __syncwarp();
      }
    }
    wmma::store_matrix_sync(tile_s[warp], acc, kTile, wmma::mem_row_major);
    __syncwarp();
    if (lane < kTile) total_s[warp][lane] = tile_s[warp][lane * kTile];
    __syncthreads();
    if (lane < kTile) {
      float c = 0.f;
      for (int p = 0; p < part; ++p) c += total_s[g * wpg + p][lane];
      carry_s[warp][lane] = c;
    }
  }
  __syncwarp();

  FragB<FT> u;
  wmma::load_matrix_sync(u, u_s, kTile);
  if (!live) return;
  scan_range<T, VEC>(x, out, rows, n, row0, lo, hi, stage_s[warp],
                     tile_s[warp], carry_s[warp], u, lane);
}

template <typename T>
static int launch(const void* x, void* out, long long rows, long long n,
                  cudaStream_t stream) {
  const int wpg = warps_per_group(rows, n);
  // contiguous column ranges, each a whole number of staged blocks
  const long long per = (n + wpg - 1) / wpg;
  const long long span = (per + kCols - 1) / kCols * kCols;
  const long long per_block = (long long)(kWarps / wpg) * kTile;
  const unsigned blocks = (unsigned)((rows + per_block - 1) / per_block);
  const T* xp = static_cast<const T*>(x);
  float* op = static_cast<float*>(out);
  if (vec_ok(x, n, sizeof(T)))
    tcu_scan_kernel<T, true>
        <<<blocks, kWarps * 32, 0, stream>>>(xp, op, rows, n, wpg, span);
  else
    tcu_scan_kernel<T, false>
        <<<blocks, kWarps * 32, 0, stream>>>(xp, op, rows, n, wpg, span);
  return (int)cudaGetLastError();
}

}  // namespace rt

// x: (rows, n) contiguous, dtype code; out: (rows, n) f32.
extern "C" int tcu_scan_launch(const void* x, void* out, long long rows,
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
