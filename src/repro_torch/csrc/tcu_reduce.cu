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
// Design: the input stays in the model layout (rows, n); no transpose. The
// streaming loop of tcu_tile.cuh (piece_totals_kernel): a warp owns 16
// pieces (rows, or column ranges of rows) and walks them 64 bytes per quad
// per step, a batch of 8 steps of 16-byte loads in flight per lane; each
// step's row sums are A @ 1 on mma.sync from the registers as loaded (f32
// as three exact bf16 parts), added in f32 registers. The launch plan
// (kernels/layout.py, reduce_scan_plan) keeps one piece per row when the
// rows' 16-row groups fill the card. Few long rows (and fewer than 16 rows)
// are cut into pieces: 2 to 16 a row are added inside the warp that holds
// them, in one launch; with more, each warp adds its run of 16 pieces into
// a workspace and a second launch sums each row's runs in a fixed order
// (combine_pieces). No atomics: the same input gives the same bits on every
// launch. Loads are 16 bytes per lane where n and the pointer allow;
// otherwise element by element.
#include "tcu_tile.cuh"

namespace rt {

__global__ void tcu_reduce_combine_kernel(const float* __restrict__ ws,
                                          float* __restrict__ out,
                                          long long pieces) {
  combine_pieces<false>(ws, out, pieces);
}

template <typename T>
static int launch(const void* x, void* out, void* ws, const Pieces& geo,
                  int blocks, int combine_threads, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const long long runs = geo.pieces / geo.fold;   // sums a row writes
  float* dst = static_cast<float*>(runs > 1 ? ws : out);
  launch_totals<T>(xp, dst, geo, blocks, stream);
  if (runs > 1)
    tcu_reduce_combine_kernel<<<(unsigned)geo.rows, combine_threads, 0,
                                stream>>>(dst, static_cast<float*>(out),
                                          runs);
  return (int)cudaGetLastError();
}

}  // namespace rt

// x: (rows, n) contiguous, dtype code; out: (rows,) f32; ws: rows * pieces
// / fold f32 (unused when a row's pieces fold into one sum). pieces, len,
// blocks, combine_threads: the plan of kernels/layout.py::reduce_scan_plan.
extern "C" int tcu_reduce_launch(const void* x, void* out, void* ws,
                                 long long rows, long long n,
                                 long long pieces, long long len, int blocks,
                                 int combine_threads, int dtype,
                                 void* stream) {
  const rt::Pieces geo{rows, n, pieces, len,
                       rt::Pieces::fold_for(pieces, true)};
  if (rows < 1 || n < 1 || pieces < 1 || len < 1 || blocks < 1 ||
      pieces * len < n ||
      (pieces > geo.fold &&
       (ws == nullptr || combine_threads < 32 || combine_threads > 1024 ||
        combine_threads % 32)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return rt::launch<float>(x, out, ws, geo, blocks, combine_threads, st);
    case rt::kF16:
      return rt::launch<__half>(x, out, ws, geo, blocks, combine_threads, st);
    case rt::kBF16:
      return rt::launch<__nv_bfloat16>(x, out, ws, geo, blocks,
                                       combine_threads, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
