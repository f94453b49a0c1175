// Segmented inclusive scan on tensor cores: the paper's A @ U with a carry.
//
// Replaces src/repro/kernels/tcu_scan.py::tcu_segmented_scan_tn (and its
// Pallas-Triton twin src/repro/kernels/triton/tcu_scan.py::
// triton_segmented_scan): out[r, j] = sum_{k <= j} x[r, k] in f32.
//
// Bound on an H100: bytes. One read of the input and one f32 write of the
// output; the arithmetic is one addition per element.
//
// Design: the streaming loop of tcu_tile.cuh. A warp owns 16 pieces (rows,
// or column ranges of rows) and walks them a step at a time: each lane's
// 16-byte loads of pieces g and g + 8 are the A fragment of mma.sync as
// they are, times the triangle U with its rows permuted to the order the
// registers hold (f32 as three exact bf16 parts). The accumulators stay in
// registers: the step's row totals (its last column) reach each quad by
// one shuffle, the per-row carry is added there, and the f32 prefix is
// written as 8-byte streaming stores. The paper's Broadcast(LastColumn(R))
// carry is that running register sum.
//
// The launch plan (kernels/layout.py, reduce_scan_plan) keeps one piece per
// row when the rows' 16-row groups fill the card. Few long rows (and fewer
// than 16 rows) are cut into pieces. With 2 to 16 pieces a row, the warp
// that holds them walks its group twice in one launch: the pieces' totals,
// their fixed-order prefix over the row by shuffles, then the scan from
// those carries (the second read mostly hits L2). With more, three
// launches: the pieces' totals (piece_totals_kernel) into a workspace, each
// row's exclusive prefix over its pieces in a fixed order
// (combine_pieces), then every piece scanned from its carry
// (piece_scan_kernel). Each piece is read twice and written once; no
// atomics, so the same input gives the same bits on every launch.
// The exclusive scan is made by a shift in the Python glue, never here as
// inclusive - x.
#include "tcu_tile.cuh"

namespace rt {

__global__ void tcu_scan_carry_kernel(const float* __restrict__ totals,
                                      float* __restrict__ carry,
                                      long long pieces) {
  combine_pieces<true>(totals, carry, pieces);
}

template <typename T>
static int launch(const void* x, void* out, void* ws, const Pieces& geo,
                  int blocks, int combine_threads, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  float* op = static_cast<float*>(out);
  const float* carry = nullptr;
  if (geo.pieces > geo.fold) {
    float* totals = static_cast<float*>(ws);
    float* cin = totals + geo.count();
    launch_totals<T>(xp, totals, geo, blocks, stream);
    tcu_scan_carry_kernel<<<(unsigned)geo.rows, combine_threads, 0,
                            stream>>>(totals, cin, geo.pieces);
    carry = cin;
  }
  launch_scan<T>(xp, op, carry, geo, blocks, stream);
  return (int)cudaGetLastError();
}

}  // namespace rt

// x: (rows, n) contiguous, dtype code; out: (rows, n) f32; ws: 2 * rows *
// pieces f32 (unused when a row's pieces fold into one group). pieces, len,
// blocks, combine_threads: the plan of kernels/layout.py::reduce_scan_plan.
extern "C" int tcu_scan_launch(const void* x, void* out, void* ws,
                               long long rows, long long n, long long pieces,
                               long long len, int blocks, int combine_threads,
                               int dtype, void* stream) {
  const rt::Pieces geo{rows, n, pieces, len,
                       rt::Pieces::fold_for(pieces, false)};
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
