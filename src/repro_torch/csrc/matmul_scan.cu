// The carry-free local passes of the log-depth MatMulScan family.
//
// Replaces the three Pallas kernels of src/repro/kernels/matmul_scan.py
// (and their Pallas-Triton twins in src/repro/kernels/triton/
// matmul_scan.py): matmul_local_scan, matmul_local_weighted and
// matmul_local_ssd. Each scans blocks of its input independently, with no
// carry from one block to the next; kernels/matmul_scan.py then stitches
// the blocks with a tree of O(log_radix nblocks) batched matmuls against
// constant matrices. The linear kernels (tcu_scan.cu, ssd_scan.cu) walk a
// row's blocks in order; here every block is an independent block of the
// grid, so a long row fills the card.
//
//   local_scan      out = per block_n block of a row, inclusive scan:
//                   tcu_tile.cuh's streaming A @ U loop (mma.sync from
//                   registers, f32 as three bf16 parts) with every block
//                   a piece whose carry starts at zero; a warp owns 16
//                   blocks.
//                   Bound: bytes (one read, one f32 write).
//   local_weighted  y = exp(segsum(lambda)) x per q block of a row (q = 16,
//                   32, 64 or 128): wscan_tile.cuh's streaming loop, the
//                   weighted scan's, with the tree on segments of q / 8
//                   lanes and no carry between steps, so every block starts
//                   from zero. Per element one exp and a few FMAs; no
//                   subtraction of log-decays, so a log_a of -inf stays
//                   finite. A warp owns a piece of whole steps (a row, or a
//                   column range of one cut so that few long rows fill the
//                   card). Bound: bytes (two f32 reads, one f32 write).
//   local_ssd       per (batch, head, chunk of q steps): y_local =
//                   ((C B^T) o M) (dt o X) and the chunk state S = (B o
//                   w)^T (dt o X), the chunk body of ssd_scan.cu without
//                   the carried H (ssd_chunk.cuh), in its two instances.
//                   Every chunk is independent, so the grid is fully
//                   parallel. It writes more than it reads: S is N x P f32
//                   per chunk against q x (P + 2N) 16-bit inputs, 119 MB in
//                   all at B=4 L=512 H=64 of which the f32 outputs are
//                   100 MB. Bound: bytes. f16 / bf16 (ssd_mma_fits):
//                   tc_chunk_loop without the carry, two blocks of four
//                   warps per SM, each walking the chunks strided by the
//                   grid with the next chunk's loads in flight (a two-stage
//                   cp.async ring); the products on the tensor cores
//                   (mma.sync, hi/lo pairs for the f32-formed operands);
//                   each warp stages its rows p of y_local and S through its
//                   own columns of the consumed C tile (transposed from its
//                   accumulators) and writes them as 16-byte coalesced rows
//                   of the model layout. f32 and other shapes: one block
//                   per chunk, FMA loops.
//
// Ragged edges are zero-filled in shared memory (steps past L or n load
// lambda = 0, x = 0, b = c = 0), so the glue pads nothing; shapes a kernel
// does not take return cudaErrorInvalidValue.
#include <algorithm>
#include <type_traits>

#include "ssd_chunk.cuh"
#include "tcu_tile.cuh"
#include "wscan_tile.cuh"

namespace rt {

// ---------------------------------------------------------------------------
// local scan: tcu_tile.cuh's piece scan with one piece per block_n columns
// and no carry into a piece

template <typename T>
static int launch_local_scan(const void* x, void* out, long long rows,
                             long long n, int block_n, cudaStream_t stream) {
  const long long pieces = (n + block_n - 1) / block_n;
  const Pieces geo{rows, n, pieces, pieces == 1 ? n : block_n, 1};
  const long long by_items = (geo.groups() + kWarps - 1) / kWarps;
  const unsigned blocks = (unsigned)std::min<long long>(
      by_items, 8LL * sm_count());
  launch_scan<T>(static_cast<const T*>(x), static_cast<float*>(out),
                 nullptr, geo, (int)blocks, stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// local weighted scan: wscan_tile.cuh's loop, restarted every q columns

constexpr int kWtMaxQ = 128;

static int launch_local_weighted(const float* x, const float* lam, float* y,
                                 long long rows, long long n, int q,
                                 cudaStream_t stream) {
  // pieces of whole steps, short enough that the rows' pieces give every SM
  // 16 warps, and at most 16 steps long
  constexpr long long cols = wscan::kCols;
  const long long steps = (n + cols - 1) / cols;
  const long long target = 16LL * sm_count();
  long long per = (rows * steps + target - 1) / target;
  per = std::max(1LL, std::min(per, 16LL));
  const long long len = per >= steps ? n : per * cols;
  const wscan::Pieces geo{rows, n, (n + len - 1) / len, len};
  const long long by_items =
      (geo.count() + wscan::kWarps - 1) / wscan::kWarps;
  const int blocks = (int)std::min<long long>(by_items, 8LL * sm_count());
  wscan::launch_pass<float, float, wscan::kLocal>(x, lam, y, nullptr, geo,
                                                  q / wscan::kE, blocks,
                                                  stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// local SSD chunk pass

inline size_t local_ssd_smem_bytes(int q, int P, int N) {
  const size_t pp = round4(P), np = round4(N);
  return sizeof(float) * (np * (size_t)bt_stride(q) +
                          (size_t)q * cs_stride(np) + (size_t)q * pp +
                          (size_t)q * q + 2 * q);
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
    local_ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ lam, const T* __restrict__ bm,
                     const T* __restrict__ cm, float* __restrict__ y,
                     float* __restrict__ s, SsdDims d, int nchunks) {
  extern __shared__ __align__(16) float smem[];
  const int q = d.q, pp = round4(d.P), np = round4(d.N);
  float* bt = smem;              // (np, q)   B^T of the chunk
  float* cs = bt + np * bt_stride(q);  // (q, np)   C of the chunk
  float* xs = cs + q * cs_stride(np);  // (q, pp)   dt * x
  float* gs = xs + q * pp;       // (q, q)    masked C B^T
  float* cum = gs + q * q;       // (q)       Lambda
  float* wv = cum + q;           // (q)       exp(Lambda_last - Lambda)

  const int chunk = blockIdx.x % nchunks, bh = blockIdx.x / nchunks;
  const int bi = bh / d.H, h = bh % d.H, g = h / (d.H / d.G);
  const int c0 = chunk * q, tid = threadIdx.x;
  const int nt = q / 4, ntp = pp / 4, ntn = np / 4;

  stage_chunk<T>(x, dt, lam, bm, cm, d, bi, h, g, c0, bt, cs, xs, cum, tid);
  __syncthreads();
  if (tid < 32) chunk_cumsum(cum, wv, q, tid);
  __syncthreads();
  masked_cb(bt, cs, cum, gs, q, np, tid);
  __syncthreads();

  // y_local = G (dt o X), f32 in the model layout (B, L, H, P)
  for (int tile = tid; tile < nt * ntp; tile += kSsdThreads) {
    const int t0 = (tile / ntp) * 4, p0 = (tile % ntp) * 4;
    float yi[4][4] = {};
    intra_tile(gs, xs, q, pp, t0, p0, yi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = c0 + t0 + i;
      if (l >= d.L) continue;
      float* yrow = y + (((long long)bi * d.L + l) * d.H + h) * d.P;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j < d.P) yrow[p0 + j] = yi[i][j];
    }
  }

  // S = (B o w)^T (dt o X), f32 (B, H, nchunks, N, P)
  float* sc = s + ((long long)bh * nchunks + chunk) * d.N * d.P;
  for (int tile = tid; tile < ntn * ntp; tile += kSsdThreads) {
    const int n0 = (tile / ntp) * 4, p0 = (tile % ntp) * 4;
    float acc[4][4] = {};
    state_tile(bt, xs, wv, q, pp, n0, p0, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (n0 + i >= d.N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (p0 + j < d.P) sc[(n0 + i) * d.P + p0 + j] = acc[i][j];
    }
  }
}

// f16 / bf16: the tensor-core chunk loop of ssd_chunk.cuh without the carry,
// a block per pair of SM slots walking the chunks strided by the grid

template <typename T>
__global__ void __launch_bounds__(kTcThreads, 2)
    local_ssd_mma_kernel(const T* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ lam,
                         const T* __restrict__ bm, const T* __restrict__ cm,
                         float* __restrict__ y, float* __restrict__ s,
                         SsdDims d) {
  extern __shared__ __align__(128) unsigned char ls_raw[];
  tc_chunk_loop<T, false>(x, dt, lam, bm, cm, y, s, d, ls_raw);
}

template <typename T>
static int launch_ssd(const void* x, const void* dt, const void* lam,
                      const void* b, const void* c, void* y, void* s,
                      const SsdDims& d, int dtype, cudaStream_t stream) {
  const int nchunks = (d.L + d.q - 1) / d.q;
  const long long blocks = (long long)d.B * d.H * nchunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if constexpr (!std::is_same<T, float>::value) {
    if (ssd_mma_fits(dtype, d.q, d.P, d.N)) {
      if (!tc_rows_aligned(x, b, c, d)) return (int)cudaErrorInvalidValue;
      cudaError_t err = cudaFuncSetAttribute(
          local_ssd_mma_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
      if (err != cudaSuccess) return (int)err;
      // two blocks per SM, each walking its share of the chunks
      const long long grid = std::min(blocks, 2LL * sm_count());
      local_ssd_mma_kernel<T><<<(unsigned)grid, kTcThreads, kTcSmem,
                                stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(dt),
          static_cast<const float*>(lam), static_cast<const T*>(b),
          static_cast<const T*>(c), static_cast<float*>(y),
          static_cast<float*>(s), d);
      return (int)cudaGetLastError();
    }
  }
  const size_t smem = local_ssd_smem_bytes(d.q, d.P, d.N);
  cudaError_t err = cudaFuncSetAttribute(
      local_ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  local_ssd_kernel<T><<<(unsigned)blocks, kSsdThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(lam), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<float*>(y),
      static_cast<float*>(s), d, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace rt

// x: (rows, n) contiguous, dtype code; out: (rows, n) f32. block_n must be
// a positive multiple of 32 (whole steps of the streaming loop).
extern "C" int matmul_local_scan_launch(const void* x, void* out,
                                        long long rows, long long n,
                                        int block_n, int dtype,
                                        void* stream) {
  if (rows < 1 || n < 1 || block_n < 32 || block_n % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return rt::launch_local_scan<float>(x, out, rows, n, block_n, st);
    case rt::kF16:
      return rt::launch_local_scan<__half>(x, out, rows, n, block_n, st);
    case rt::kBF16:
      return rt::launch_local_scan<__nv_bfloat16>(x, out, rows, n, block_n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// x, lam, y: (rows, n) f32 contiguous. q must be 16, 32, 64 or 128.
extern "C" int matmul_local_weighted_launch(const void* x, const void* lam,
                                            void* y, long long rows,
                                            long long n, int q,
                                            void* stream) {
  if (rows < 1 || n < 1 || q < 16 || q > rt::kWtMaxQ || (q & (q - 1)))
    return (int)cudaErrorInvalidValue;
  return rt::launch_local_weighted(
      static_cast<const float*>(x), static_cast<const float*>(lam),
      static_cast<float*>(y), rows, n, q, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory the local SSD pass's FMA instance needs at chunk q
// (bytes).
extern "C" long long matmul_local_ssd_smem_bytes(int q, int P, int N) {
  return (long long)rt::local_ssd_smem_bytes(q, P, N);
}

// x, b, c share the dtype code; dt, lam f32; y (B, L, H, P) and s
// (B, H, ceil(L / q), N, P) f32 contiguous. q must be a multiple of 16 and
// H of G. The tensor-core instance (ssd_uses_mma) also needs 16-byte
// aligned x, b, c and strides that are multiples of 8 elements.
extern "C" int matmul_local_ssd_launch(
    const void* x, const void* dt, const void* lam, const void* b,
    const void* c, void* y, void* s, int dtype, int B, int L, int H, int G,
    int P, int N, int q, long long sxb, long long sxl, long long sxh,
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
      return rt::launch_ssd<float>(x, dt, lam, b, c, y, s, d, dtype, st);
    case rt::kF16:
      return rt::launch_ssd<__half>(x, dt, lam, b, c, y, s, d, dtype, st);
    case rt::kBF16:
      return rt::launch_ssd<__nv_bfloat16>(x, dt, lam, b, c, y, s, d, dtype,
                                           st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
