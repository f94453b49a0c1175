// The decayed (weighted) scan y_t = exp(log_a_t) y_{t-1} + x_t along rows.
//
// Replaces src/repro/kernels/ssd_scan.py::ssd_chunk_scan in the role the
// reference gives it for the weighted scan (src/repro/kernels/ops.py, the SSD
// kernel at N = P = 1, B = C = 1), and its Pallas-Triton twin
// src/repro/kernels/triton/ssd_scan.py::triton_ssd_chunk_scan. x and log_a
// are read in their own dtype (f32, f16 or bf16; log_a either x's dtype or
// f32), y is written in f32.
//
// Bound on an H100: bytes. One read of x and of log_a and one f32 write of
// y, itemsize(x) + itemsize(log_a) + 4 bytes per element; the work is one
// exp and a few FMAs per element, far under the card's rates.
//
// Design: the streaming loop of wscan_tile.cuh. A warp owns one piece (a
// row, or a column range of one) and walks it 256 columns a step: 16-byte
// loads of x and log_a, a scan of each lane's 8 columns in registers, a
// 5-step shuffle scan of the lanes' (summed log-decay, state) pairs, and
// the row's state carried in a register from one step to the next. The
// launch plan (kernels/layout.py, weighted_scan_plan) keeps one piece per
// row when the rows fill the card, one launch (whole rows of one or two
// steps go four or two to a warp). Fewer rows of up to 8192 columns are cut
// into 2, 4 or 8 pieces of one batch of loads, the warps of one block
// (wscan_fold_kernel): each takes its piece's total pair from the loaded
// registers, the block joins the row's pairs in order through shared
// memory, and each warp scans its registers again from its carry, one read
// and one launch. Few long rows are cut into pieces, three launches: every
// piece's total pair into a workspace (wscan_pass_kernel, kTotals), each
// row's carries from those pairs in a fixed order (wscan_carry_kernel),
// then every piece scanned from its carry. Each piece is then read twice
// and written once. No atomics and no look-back: the same input gives the
// same bits on every launch.
//
// The tensor cores are not used: see wscan_tile.cuh (a decay per element
// gives every block its own matrix, and the rescaled form that would share
// one overflows f32).
#include "wscan_tile.cuh"

namespace rt {
namespace wscan {

// Per row: cin[r, p] = the state entering piece p of row r from a zero
// start, from the pieces' totals lam[r, p] (summed log-decay) and h[r, p]
// (state from zero), in a fixed order. One block per row of blockDim.x
// threads (a multiple of 32, at most 1024): thread t folds pieces
// [t k, t k + k) in order, k = ceil(pieces / blockDim.x); the threads' pairs
// are scanned by shuffles in each warp and over the warps through shared
// memory; each thread then walks its pieces again from its carry.
__global__ void wscan_carry_kernel(const float* __restrict__ lam,
                                   const float* __restrict__ h,
                                   float* __restrict__ cin,
                                   long long pieces) {
  __shared__ float warp_l[32], warp_h[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  const long long k = (pieces + blockDim.x - 1) / blockDim.x;
  const long long p0 = threadIdx.x * k;
  const long long p1 = p0 + k < pieces ? p0 + k : pieces;
  const float* lr = lam + blockIdx.x * pieces;
  const float* hr = h + blockIdx.x * pieces;
  float* cr = cin + blockIdx.x * pieces;
  float tl = 0.f, th = 0.f;
  for (long long p = p0; p < p1; ++p) {
    th = fmaf(__expf(lr[p]), th, hr[p]);
    tl += lr[p];
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ul = __shfl_up_sync(kFull, tl, d);
    const float uh = __shfl_up_sync(kFull, th, d);
    if (lane >= d) {
      th = fmaf(__expf(tl), uh, th);
      tl += ul;
    }
  }
  if (lane == 31) {
    warp_l[warp] = tl;
    warp_h[warp] = th;
  }
  __syncthreads();
  if (warp == 0) {
    float wl = lane < nw ? warp_l[lane] : 0.f;
    float wh = lane < nw ? warp_h[lane] : 0.f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float ul = __shfl_up_sync(kFull, wl, d);
      const float uh = __shfl_up_sync(kFull, wh, d);
      if (lane >= d) {
        wh = fmaf(__expf(wl), uh, wh);
        wl += ul;
      }
    }
    // the state entering each warp's first thread
    const float eh = __shfl_up_sync(kFull, wh, 1);
    if (lane < nw) warp_h[lane] = lane == 0 ? 0.f : eh;
  }
  __syncthreads();
  float el = __shfl_up_sync(kFull, tl, 1);
  float eh = __shfl_up_sync(kFull, th, 1);
  if (lane == 0) el = eh = 0.f;
  float c = fmaf(__expf(el), warp_h[warp], eh);
  for (long long p = p0; p < p1; ++p) {
    cr[p] = c;
    c = fmaf(__expf(lr[p]), c, hr[p]);
  }
}

template <typename TX, typename TA>
static int launch(const void* x, const void* la, void* y, void* ws,
                  const Pieces& geo, int blocks, int combine_threads,
                  cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TA* ap = static_cast<const TA*>(la);
  if (fold_ok(geo)) {
    launch_fold<TX, TA>(xp, ap, static_cast<float*>(y), geo, blocks, stream);
    return (int)cudaGetLastError();
  }
  const float* carry = nullptr;
  if (geo.pieces > 1) {
    float* totals = static_cast<float*>(ws);
    float* cin = totals + 2 * geo.count();
    launch_pass<TX, TA, kTotals>(xp, ap, totals, nullptr, geo, 32, blocks,
                                 stream);
    wscan_carry_kernel<<<(unsigned)geo.rows, combine_threads, 0, stream>>>(
        totals, totals + geo.count(), cin, geo.pieces);
    carry = cin;
  }
  launch_pass<TX, TA, kScan>(xp, ap, static_cast<float*>(y), carry, geo, 32,
                             blocks, stream);
  return (int)cudaGetLastError();
}

}  // namespace wscan
}  // namespace rt

// x (rows, n) contiguous of dtype code x_dtype; log_a (rows, n) contiguous
// of la_dtype, which is x_dtype or f32; y (rows, n) f32. ws: 3 * rows *
// pieces f32 (unused with one piece a row, or pieces folded in a block:
// 2, 4 or 8 of at most 1024 columns). pieces, len, blocks,
// combine_threads: the plan of kernels/layout.py::weighted_scan_plan; with
// more than one piece, len is a whole number of 256-column steps.
extern "C" int weighted_scan_launch(const void* x, const void* la, void* y,
                                    void* ws, long long rows, long long n,
                                    long long pieces, long long len,
                                    int blocks, int combine_threads,
                                    int x_dtype, int la_dtype, void* stream) {
  using namespace rt;
  const wscan::Pieces geo{rows, n, pieces, len};
  if (rows < 1 || n < 1 || pieces < 1 || len < 1 || blocks < 1 ||
      pieces * len < n || (pieces > 1 && len % wscan::kCols) ||
      (pieces > 1 && !wscan::fold_ok(geo) &&
       (ws == nullptr || combine_threads < 32 || combine_threads > 1024 ||
        combine_threads % 32)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto tx, auto ta) {
    using TX = decltype(tx);
    using TA = decltype(ta);
    return wscan::launch<TX, TA>(x, la, y, ws, geo, blocks, combine_threads,
                                 st);
  };
  if (la_dtype == kF32) {
    switch (x_dtype) {
      case kF32: return go(float(), float());
      case kF16: return go(__half(), float());
      case kBF16: return go(__nv_bfloat16(), float());
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (la_dtype != x_dtype) return (int)cudaErrorInvalidValue;
  switch (x_dtype) {
    case kF16: return go(__half(), __half());
    case kBF16: return go(__nv_bfloat16(), __nv_bfloat16());
    default: return (int)cudaErrorInvalidValue;
  }
}
