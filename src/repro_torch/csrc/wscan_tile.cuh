// The streaming loop of the decayed (weighted) scan: weighted_scan.cu and
// matmul_scan.cu's local weighted pass.
//
// h_t = a_t h_{t-1} + x_t with a_t = exp(lambda_t), lambda = log_a. A run of
// steps is the pair (Lambda, h): its summed log-decay and the state it
// leaves from a zero start. Two runs combine in order as
//   (Lambda_1, h_1) . (Lambda_2, h_2) = (Lambda_1 + Lambda_2,
//                                        exp(Lambda_2) h_1 + h_2),
// an associative operator, so a warp scans its columns as a tree. Decays are
// only ever summed and exponentiated, never subtracted: a log_a of -inf (a
// hard reset) is an exp of -inf, 0, and every state stays finite.
//
// A warp owns one piece (a row, or a column range [p * len, ...) of one)
// and walks it in steps of 256 columns. Lane l holds columns 8l .. 8l + 7
// of the step, read as 16-byte loads of x and of log_a in their own dtype
// (one load of a 16-bit array, two of an f32 one), and scans them in
// registers: per element one exp, one FMA for h and one multiply for the
// running decay P_j = exp(Lambda_j) of the lane's run. A 5-step shuffle
// scan of the lanes' run pairs follows; each lane then takes the exclusive
// pair of the lanes before it and the warp's carried state c, and writes
// y_j = h_j + P_j (h_excl + exp(Lambda_excl) c). The step's total, broadcast
// from lane 31, carries c to the next step in a register. A batch of
// kDepth steps (of up to kMaxGroups whole short rows at once) is loaded
// before it is consumed, as in tcu_tile.cuh.
//
// The local pass (matmul_local_weighted) restarts every q columns: the tree
// runs on segments of q / 8 lanes and nothing is carried between steps.
//
// Why not the tensor cores: with a decay per element every block of q
// columns has its own q x q matrix exp(segsum(lambda)), q / 2 exps per
// element to build. The rescaled form exp(Lambda_t) cumsum(exp(-Lambda_s)
// x_s) would be tcu_tile.cuh's A @ U, but exp(-Lambda_s) overflows f32 once
// a block's log-decay falls below about -88 (16 steps of log_a = -6).
//
// Everything runs in a fixed order (lanes, tree, steps, pieces): the same
// input gives the same bits on every launch.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rt {
namespace wscan {

constexpr int kWarps = 8;          // warps per block
constexpr int kE = 8;              // elements per lane per step
constexpr int kCols = 32 * kE;     // columns per step
constexpr int kDepth = 4;          // steps of loads in flight per warp
constexpr int kMaxGroups = 4;      // whole short rows a warp takes at once
constexpr unsigned kFull = 0xffffffffu;

// What a pass does with its pieces.
enum Mode : int {
  kTotals = 0,   // write each piece's (Lambda, h) from a zero start
  kScan = 1,     // write the scan of each piece from its carry
  kLocal = 2,    // write the scan of every q block, each from zero
};

// Piece geometry: piece v = r * pieces + p covers columns [p * len,
// min(n, (p + 1) * len)) of row r of a (rows, n) array.
struct Pieces {
  long long rows, n, pieces, len;

  __host__ __device__ long long count() const { return rows * pieces; }
  // offset of piece v's first element and its length (0 past the array)
  __device__ void locate(long long v, long long& base, long long& ext) const {
    if (v >= count()) {
      base = 0;
      ext = 0;
      return;
    }
    const long long r = v / pieces, c0 = (v - r * pieces) * len;
    base = r * n + c0;
    ext = n - c0 < len ? n - c0 : len;
    if (ext < 0) ext = 0;       // a folded row's empty tail piece
  }
};

// The lane's 8 elements of one array as 16-byte registers.
template <typename T>
struct Run {
  static constexpr int kRegs = (int)sizeof(T) * kE / 16;
  uint4 r[kRegs];
};

// Columns [col, col + 8) of a piece at p (those at or past ext read as 0).
// VEC: p and col are 16-byte aligned and ext is a multiple of 8, so the run
// is wholly in or out.
template <typename T, bool VEC>
__device__ __forceinline__ void load_run(Run<T>& out, const T* __restrict__ p,
                                         long long col, long long ext) {
  if constexpr (VEC) {
    const uint4* src = reinterpret_cast<const uint4*>(p + col);
#pragma unroll
    for (int j = 0; j < Run<T>::kRegs; ++j)
      out.r[j] = col < ext ? __ldg(src + j) : make_uint4(0u, 0u, 0u, 0u);
  } else {
    union {
      uint4 u[Run<T>::kRegs];
      T e[kE];
    } t;
#pragma unroll
    for (int j = 0; j < kE; ++j)
      t.e[j] = col + j < ext ? p[col + j] : from_f32<T>(0.f);
#pragma unroll
    for (int j = 0; j < Run<T>::kRegs; ++j) out.r[j] = t.u[j];
  }
}

__device__ __forceinline__ void words(const uint4& v, uint32_t (&w)[4]) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

__device__ __forceinline__ void unpack(const Run<float>& r, float (&f)[kE]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    uint32_t w[4];
    words(r.r[j], w);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[4 * j + i] = __uint_as_float(w[i]);
  }
}

__device__ __forceinline__ void unpack(const Run<__nv_bfloat16>& r,
                                       float (&f)[kE]) {
  uint32_t w[4];
  words(r.r[0], w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {     // low half first: the earlier column
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void unpack(const Run<__half>& r, float (&f)[kE]) {
  uint32_t w[4];
  words(r.r[0], w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned short lo = (unsigned short)(w[i] & 0xFFFFu);
    const unsigned short hi = (unsigned short)(w[i] >> 16);
    f[2 * i] = __half2float(__ushort_as_half(lo));
    f[2 * i + 1] = __half2float(__ushort_as_half(hi));
  }
}

// One step of a piece: the lane's run, the tree over segments of `seg`
// lanes, the outputs, and the carry. y: the piece's output (x's layout),
// col0: the step's first column, ext: the piece's length. c: the state
// entering the step (kScan; kTotals also), lam: the piece's summed
// log-decay so far (kTotals).
template <int MODE, bool VEC, typename TX, typename TA>
__device__ __forceinline__ void consume(const Run<TX>& rx, const Run<TA>& ra,
                                        float* __restrict__ y, long long col0,
                                        long long ext, float& c, float& lam,
                                        int seg, int lane) {
  float xv[kE], la[kE];
  unpack(rx, xv);
  unpack(ra, la);
  // the lane's run from a zero start: states h_j and decays P_j
  float h[kE], p[kE];
  float run_lam = la[0];
  h[0] = xv[0];
  p[0] = __expf(la[0]);
#pragma unroll
  for (int j = 1; j < kE; ++j) {
    const float a = __expf(la[j]);
    h[j] = fmaf(a, h[j - 1], xv[j]);
    p[j] = p[j - 1] * a;
    run_lam += la[j];
  }
  // inclusive scan of the runs over each segment of `seg` lanes
  float tl = run_lam, th = h[kE - 1];
  const int li = lane & (seg - 1);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d >= seg) break;
    const float ul = __shfl_up_sync(kFull, tl, d);
    const float uh = __shfl_up_sync(kFull, th, d);
    if (li >= d) {
      th = fmaf(__expf(tl), uh, th);
      tl += ul;
    }
  }
  if constexpr (MODE != kTotals) {
    float el = __shfl_up_sync(kFull, tl, 1);
    float eh = __shfl_up_sync(kFull, th, 1);
    if (li == 0) el = eh = 0.f;
    // the state entering the lane's first column
    const float cl = MODE == kScan ? fmaf(__expf(el), c, eh) : eh;
    float o[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) o[j] = fmaf(p[j], cl, h[j]);
    const long long col = col0 + (long long)lane * kE;
    if constexpr (VEC) {
      if (col < ext) {
        float4* dst = reinterpret_cast<float4*>(y + col);
        __stcs(dst, make_float4(o[0], o[1], o[2], o[3]));
        __stcs(dst + 1, make_float4(o[4], o[5], o[6], o[7]));
      }
    } else {
#pragma unroll
      for (int j = 0; j < kE; ++j)
        if (col + j < ext) y[col + j] = o[j];
    }
  }
  if constexpr (MODE != kLocal) {
    const float sl = __shfl_sync(kFull, tl, 31);
    const float sh = __shfl_sync(kFull, th, 31);
    c = fmaf(__expf(sl), c, sh);
    lam += sl;
  }
}

// The streaming pass. Each warp walks its items grid-stride; an item is K
// consecutive pieces (K > 1 only for whole rows of one step, so that short
// rows still keep a batch of loads in flight), walked kDepth / K steps a
// batch: every load of a batch is issued, then the batch is consumed in
// order.
//   kTotals: out[v] = the piece's summed log-decay, out[count + v] = its
//            state from zero.
//   kScan:   out (x's layout) = the scan of every piece from cin[v] (cin
//            null: from zero).
//   kLocal:  out = the scan of every block of q = 8 * seg columns from zero
//            (pieces are whole numbers of steps, so whole blocks).
template <typename TX, typename TA, bool VEC, int K, int MODE>
__global__ void __launch_bounds__(kWarps * 32, 2)
    wscan_pass_kernel(const TX* __restrict__ x, const TA* __restrict__ la,
                      float* __restrict__ out, const float* __restrict__ cin,
                      Pieces geo, int seg) {
  constexpr int SS = kDepth / K;
  static_assert(SS >= 1 && SS * K == kDepth, "a batch is kDepth steps");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long steps = (geo.len + kCols - 1) / kCols;
  const long long stride = (long long)gridDim.x * kWarps;
  const long long count = geo.count();
  for (long long item = (long long)blockIdx.x * kWarps + warp;
       item * K < count; item += stride) {
    long long base[K], ext[K];
    float c[K], lam[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const long long v = item * K + k;
      geo.locate(v, base[k], ext[k]);
      c[k] = MODE == kScan && cin != nullptr && ext[k] > 0 ? cin[v] : 0.f;
      lam[k] = 0.f;
    }
    for (long long s0 = 0; s0 < steps; s0 += SS) {
      Run<TX> rx[K][SS];
      Run<TA> ra[K][SS];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < SS; ++i) {
          const long long col = (s0 + i) * kCols + (long long)lane * kE;
          load_run<TX, VEC>(rx[k][i], x + base[k], col, ext[k]);
          load_run<TA, VEC>(ra[k][i], la + base[k], col, ext[k]);
        }
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < SS; ++i) {
          if (s0 + i >= steps) break;
          consume<MODE, VEC>(rx[k][i], ra[k][i], out + base[k],
                             (s0 + i) * kCols, ext[k], c[k], lam[k], seg,
                             lane);
        }
    }
    if constexpr (MODE == kTotals) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const long long v = item * K + k;
        if (lane == 0 && v < count) {
          out[v] = lam[k];
          out[count + v] = c[k];
        }
      }
    }
  }
}

// Rows of 2, 4 or 8 pieces of at most one batch each, folded in a block:
// the block's warps hold the pieces of kWarps / pieces rows. Each warp
// loads its batch, takes its piece's total from zero, and passes it
// through shared memory; then it folds the totals of its row's earlier
// pieces in order into its carry and scans its batch again from the
// registers. One read, one launch.
template <typename TX, typename TA, bool VEC>
__global__ void __launch_bounds__(kWarps * 32, 2)
    wscan_fold_kernel(const TX* __restrict__ x, const TA* __restrict__ la,
                      float* __restrict__ out, Pieces geo) {
  __shared__ float fold_l[kWarps], fold_h[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int first = warp - warp % (int)geo.pieces;   // the row's first warp
  const long long steps = (geo.len + kCols - 1) / kCols;   // <= kDepth
  for (long long g0 = (long long)blockIdx.x * kWarps; g0 < geo.count();
       g0 += (long long)gridDim.x * kWarps) {
    long long base, ext;
    geo.locate(g0 + warp, base, ext);
    Run<TX> rx[kDepth];
    Run<TA> ra[kDepth];
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const long long col = (long long)i * kCols + (long long)lane * kE;
      load_run<TX, VEC>(rx[i], x + base, col, ext);
      load_run<TA, VEC>(ra[i], la + base, col, ext);
    }
    float c = 0.f, lam = 0.f;
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      if (i >= steps) break;
      consume<kTotals, VEC>(rx[i], ra[i], out + base, (long long)i * kCols,
                            ext, c, lam, 32, lane);
    }
    if (lane == 0) {
      fold_l[warp] = lam;
      fold_h[warp] = c;
    }
    __syncthreads();
    c = 0.f;
    for (int j = first; j < warp; ++j)
      c = fmaf(__expf(fold_l[j]), c, fold_h[j]);
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      if (i >= steps) break;
      consume<kScan, VEC>(rx[i], ra[i], out + base, (long long)i * kCols, ext,
                          c, lam, 32, lane);
    }
    __syncthreads();            // fold_* are rewritten by the next rows
  }
}

// Whether a row's pieces fold into one block (wscan_fold_kernel).
inline bool fold_ok(const Pieces& geo) {
  return geo.pieces > 1 && geo.pieces <= kWarps && kWarps % geo.pieces == 0 &&
         geo.len <= (long long)kDepth * kCols;
}

inline bool vec_ok(const void* x, const void* la, const void* out,
                   long long n, long long len) {
  return n % kE == 0 && len % kE == 0 && aligned16(x) && aligned16(la) &&
         aligned16(out);
}

// Whole rows a warp takes at once: up to kMaxGroups rows of one step, two
// of two steps (more would cost the registers of a second block per SM).
inline int batch_groups(const Pieces& geo) {
  const long long steps = (geo.len + kCols - 1) / kCols;
  int k = 1;
  while (geo.pieces == 1 && k < kMaxGroups && steps * k * 2 <= kDepth) k *= 2;
  return k;
}

template <typename TX, typename TA>
void launch_fold(const TX* x, const TA* la, float* out, const Pieces& geo,
                 int blocks, cudaStream_t stream) {
  const long long need = (geo.count() + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(need < blocks ? need : blocks);
  if (vec_ok(x, la, out, geo.n, geo.len))
    wscan_fold_kernel<TX, TA, true><<<grid, kWarps * 32, 0, stream>>>(
        x, la, out, geo);
  else
    wscan_fold_kernel<TX, TA, false><<<grid, kWarps * 32, 0, stream>>>(
        x, la, out, geo);
}

// Launch one pass over x's pieces: the 16-byte loads and stores where x,
// log_a, out, n and len allow, with the K of batch_groups (kScan, kLocal),
// on at most `blocks` blocks.
template <typename TX, typename TA, int MODE>
void launch_pass(const TX* x, const TA* la, float* out, const float* cin,
                 const Pieces& geo, int seg, int blocks,
                 cudaStream_t stream) {
  auto go = [&](auto vec, auto kk) {
    constexpr bool V = decltype(vec)::value;
    constexpr int K = decltype(kk)::value;
    const long long need =
        (geo.count() + (long long)kWarps * K - 1) / ((long long)kWarps * K);
    const unsigned grid = (unsigned)(need < blocks ? need : blocks);
    wscan_pass_kernel<TX, TA, V, K, MODE><<<grid, kWarps * 32, 0, stream>>>(
        x, la, out, cin, geo, seg);
  };
  using std::integral_constant;
  if (!vec_ok(x, la, out, geo.n, geo.len))
    return go(std::false_type(), integral_constant<int, 1>());
  if constexpr (MODE != kTotals) {
    const int k = batch_groups(geo);
    if (k >= 4) return go(std::true_type(), integral_constant<int, 4>());
    if (k >= 2) return go(std::true_type(), integral_constant<int, 2>());
  }
  go(std::true_type(), integral_constant<int, 1>());
}

}  // namespace wscan
}  // namespace rt
