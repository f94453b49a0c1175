// Blocked (flash) attention with GQA, causal and sliding-window masks.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (and its
// Pallas-Triton twin src/repro/kernels/triton/flash_attention.py::
// triton_flash_attention). Same function: softmax(Q K^T * scale + mask) V
// with an online softmax over KV tiles (running max m, sum l, f32
// accumulator), query head h reading KV head h / (Hq / Hkv), query rows
// offset by Lk - Lq so that the sequence ends align, whole KV tiles skipped
// outside the causal and window bounds, and l > 0 guarding the final
// division so that a row that sees nothing writes 0. As in the TPU kernel,
// l is a matrix product, P @ 1 (the paper's P-matrix row sum), taken from
// the same rounded P as the numerator P V.
//
// Bound on an H100: at the serving prefill (B=4, L=512, 32/8 heads of 64,
// bf16) bytes: about 21 MB against 4.3 GFLOP, 6.3 us at 3.35 TB/s. At one
// sequence of 4096 operations: 69 GFLOP causal, 70 us at 989 TFLOP/s. Both
// the products and the softmax's exponentials (16 per clock per SM, a
// 64th of the tensor cores' rate) are on the critical path.
//
// f16 / bf16 (the served types): a Hopper kernel. One block per (64 query
// rows, query head, batch) is one warpgroup; several blocks share an SM,
// so that one block's softmax runs while another's products occupy the
// tensor cores: at D = 64, four blocks with 64-key tiles when Lk <= 1024
// (the causal diagonal wastes less of a small tile) and three with
// 128-key tiles beyond; at D = 128, two blocks with 64-key tiles. The grid
// puts the query tile slowest, last tile first, so that the longest causal
// blocks start first. Per block:
//   - one thread issues TMA loads: Q once, then K and V tiles into a
//     two-stage ring, each stage with a full mbarrier for K and one for V.
//     A stage is refilled as soon as every warp has passed the products
//     that read it. The tensor maps run over
//     the model layout (D, H, S, B) with the caller's strides, so no
//     transposed or head-repeated copy exists; rows and head-dim columns
//     past the tensor's extent arrive as zeros. Shared tiles are 128-byte
//     swizzled (one atom is 64 columns of 8 rows), as wgmma reads them.
//   - per KV tile t the warpgroup
//       1. computes S = Q K^T with wgmma (m64n64k16 or m64n128k16) from
//          shared memory into f32 registers, in one group with step 3 of
//          tile t - 1;
//       2. runs the online softmax in those registers: masks (causal,
//          window, keys at or past Lk) only on the tiles that cross a mask
//          edge, exp2 with scale * log2(e) folded into one FMA, row maxima
//          by quad shuffles, and the correction applied in place to the O
//          and l registers;
//       3. converts P to the input type in registers and uses it as the
//          register A operand of O += P V (wgmma m64nDk16, V read from its
//          [key][D] tile as a transposed B) and of l += P @ 1 (wgmma
//          m64n8k16 against a tile of ones written once to shared memory,
//          an eighth of P V's work at D = 64).
//     O and l stay in registers for the whole KV loop. The epilogue writes
//     O / l through shared memory as 16-byte rows of the model layout
//     (B, Lq, Hq, D); rows at or past Lq and columns at or past D are not
//     stored.
//   The kernel is built for D = 64 and D = 128; a head dim that is a
//   multiple of 16 below either runs on the next one up, its extra columns
//   zero-filled by TMA and never stored. A design with 128 query rows per
//   block, a producer warpgroup and two consumer warpgroups taking turns
//   (setmaxnreg, one block per SM) measured slower at the serving shape
//   (PERF.md).
//
// f32 keeps the first version's design, as its own instance (it is not a
// served type): every product staged through shared memory with 16x16x16
// wmma fragments, each f32 operand split into three bf16 parts (hi + mid +
// lo, as in tcu_reduce/tcu_scan) keeping the six part products whose order
// is at most 2^-16, which leaves an error near f32 rounding. One block per
// (64 query rows, query head, batch), four warps of 16 rows, K and V tiles
// of 64 rows staged synchronously.
#include <type_traits>

#include "hopper.cuh"
#include "tcu_tile.cuh"

namespace rt {

constexpr int kFaMaxD = 128;

struct FaDims {
  int B, Lq, Lk, Hq, Hkv, D, window;  // window 0: none
  int causal;
  float scale;
  long long sqb, sqs, sqh;            // q (B, Lq, Hq, D), d contiguous
  long long skb, sks, skh;            // k (B, Lk, Hkv, D)
  long long svb, svs, svh;            // v (B, Lk, Hkv, D)
};

// ---------------------------------------------------------------------------
// f16 / bf16: wgmma, TMA, softmax in registers

constexpr int kFhBQ = 64;         // query rows per block: one warpgroup
constexpr int kFhThreads = 128;
constexpr int kFhStages = 2;      // K/V ring depth
constexpr int kFhAtom = 64;       // 16-bit columns of a 128-byte swizzle atom
constexpr int kFhShortLk = 1024;  // up to here D = 64 takes 64-key tiles

// Blocks that share an SM for head dim DI (64 or 128) and BK keys per KV
// tile (registers: at most 168 per thread at three blocks of 128 threads,
// 128 at four; shared memory below).
constexpr int fh_blocks_per_sm(int DI, int BK) {
  return DI == 128 ? 2 : BK == 128 ? 3 : 4;
}

// shared memory, in bytes from a 1024-byte aligned base: Q (one swizzle
// atom per 64 columns), the K and V rings, the ones tile, the mbarriers
template <int DI, int BK>
struct FhSmem {
  static constexpr int kQBytes = kFhBQ * DI * 2;
  static constexpr int kKVBytes = BK * DI * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kFhStages * kKVBytes;
  static constexpr int kOnes = kV + kFhStages * kKVBytes;
  static constexpr int kBars = kOnes + 1024;
  static constexpr int kNumBars = 1 + 2 * kFhStages;
  static constexpr int kTotal = kBars + 8 * kNumBars + 1024;  // + alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T, int DI, int kBK>
__global__ void __launch_bounds__(kFhThreads, fh_blocks_per_sm(DI, kBK))
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                                 const __grid_constant__ CUtensorMap mk,
                                 const __grid_constant__ CUtensorMap mv,
                                 T* __restrict__ out, const FaDims p) {
  using L = FhSmem<DI, kBK>;
  constexpr int kAtoms = DI / kFhAtom;
  constexpr int kSteps = kBK / 16;  // k-steps of P V
  extern __shared__ unsigned char fh_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fh_raw) + 1023) & ~uintptr_t(1023));
  T* sQ = reinterpret_cast<T*>(smem + L::kQ);
  T* sK = reinterpret_cast<T*>(smem + L::kK);
  T* sV = reinterpret_cast<T*>(smem + L::kV);
  T* sOnes = reinterpret_cast<T*>(smem + L::kOnes);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + kFhStages;

  // blocks start in the order of their linear index, x fastest: every
  // (head, batch) of the last query tile first, so that the longest causal
  // blocks start first and the last wave is short
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kFhBQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const int offs = p.Lk - p.Lq;
  const int q_valid = min(kFhBQ, p.Lq - q0);
  const float scale_log2 = p.scale * 1.4426950408889634f;  // for exp2
  // KV tiles that any of this block's rows can see
  const int q_lo = q0 + offs, q_hi = q0 + q_valid - 1 + offs;
  const int kv_end = p.causal ? min(p.Lk, q_hi + 1) : p.Lk;
  const int kv_begin =
      p.window > 0 ? (max(0, q_lo - p.window + 1) / kBK) * kBK : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kBK - 1) / kBK : 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // one thread issues every TMA load: tile t of K (or V) into stage t % 2
  auto load_k = [&](int t) {
    const int s = t % kFhStages;
    mbar_expect_tx(full_k + s, L::kKVBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load_4d(sK + s * kBK * DI + a * kBK * kFhAtom, &mk, full_k + s,
                  a * kFhAtom, hk, kv_begin + t * kBK, b);
  };
  auto load_v = [&](int t) {
    const int s = t % kFhStages;
    mbar_expect_tx(full_v + s, L::kKVBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load_4d(sV + s * kBK * DI + a * kBK * kFhAtom, &mv, full_v + s,
                  a * kFhAtom, hk, kv_begin + t * kBK, b);
  };

  // thread 0 sets up the barriers and starts the loads at once; the
  // others see the barriers after __syncthreads
  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kFhStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(full_q, L::kQBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load_4d(sQ + a * kFhBQ * kFhAtom, &mq, full_q, a * kFhAtom, h, q0,
                  b);
    for (int t = 0; t < min(kFhStages, n_tiles); ++t) {
      load_k(t);
      load_v(t);
    }
  }
  for (int i = tid; i < 512; i += kFhThreads) sOnes[i] = from_f32<T>(1.f);
  // the ones are read by wgmma, through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's two rows (accumulator rows g and g + 8 of its warp), as
  // positions in key space
  const int pos0 = q0 + warp * 16 + lane / 4 + offs;
  const int pos1 = pos0 + 8;
  const int blk_lo = q0 + offs, blk_hi = blk_lo + kFhBQ - 1;

  float o[DI / 2];
  float lacc[4];
#pragma unroll
  for (int i = 0; i < DI / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) lacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;
  const uint64_t d_ones = smem_desc(sOnes, 128, 256, 0);
  // descriptors of the tiles' bases; a k-step or a stage adds its byte
  // offset / 16 to the address field
  const uint64_t d_q = smem_desc(sQ, 16, 1024, 1);
  const uint64_t d_k = smem_desc(sK, 16, 1024, 1);
  const uint64_t d_v = smem_desc(sV, kBK * 128, 1024, 1);
  // P of the previous tile, in the register layout of wgmma's A operand:
  // k-step kk holds columns 16 kk .. 16 kk + 15, which are accumulator
  // values 8 kk .. 8 kk + 7 of S (rows g, g + 8, g, g + 8 in pairs)
  uint32_t pa[kSteps][4];

  // Iteration t issues S(t) = Q K(t)^T and O += P(t-1) V(t-1), l +=
  // P(t-1) @ 1 as one group, then, once every warp has passed the
  // barrier, refills the two stages just read (K(t + 2), V(t + 1)) and
  // runs the softmax of S(t). Iteration n_tiles adds the last P V.
  mbar_wait(full_q, 0);
  for (int t = 0; t <= n_tiles; ++t) {
    const bool has_s = t < n_tiles, has_pv = t > 0;
    const int s = t % kFhStages, ph = (t / kFhStages) & 1;
    const int sp = (t + kFhStages - 1) % kFhStages;  // stage of t - 1
    const int php = ((t + kFhStages - 1) / kFhStages - 1) & 1;
    const int j0 = kv_begin + t * kBK;
    float sc[kBK / 2];
    if (has_s) mbar_wait(full_k + s, ph);
    if (has_pv) mbar_wait(full_v + sp, php);
    wgmma_fence();
    fence_regs(o);
    fence_regs(lacc);
    if (has_s) {
#pragma unroll
      for (int kk = 0; kk < DI / 16; ++kk) {
        const int a = kk / 4, ko = (kk % 4) * 16;
        const uint64_t da = d_q + (a * kFhBQ * kFhAtom + ko) * 2 / 16;
        const uint64_t db =
            d_k + (s * kBK * DI + a * kBK * kFhAtom + ko) * 2 / 16;
        wgmma_ss(sc, da, db, kk > 0, T{});
      }
    }
    if (has_pv) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint64_t dv =
            d_v + (sp * kBK * DI + kk * 16 * kFhAtom) * 2 / 16;
        wgmma_rs<1>(o, pa[kk], dv, T{});
        wgmma_rs<0>(lacc, pa[kk], d_ones, T{});
      }
    }
    wgmma_commit();
    fence_regs(sc);
    fence_regs(o);
    fence_regs(lacc);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(o);
    fence_regs(lacc);
    if (!has_s) break;
    __syncthreads();  // every warp's products of this group are complete
    if (tid == 0) {
      if (t + kFhStages < n_tiles) load_k(t + kFhStages);
      if (has_pv && t + 1 < n_tiles) load_v(t + 1);
    }

    // online softmax of S(t) in registers; masks only where a mask edge,
    // or the end of the keys, crosses this block's part of the tile
    const bool edge = j0 + kBK > p.Lk ||
                      (p.causal && j0 + kBK - 1 > blk_lo) ||
                      (p.window > 0 && j0 <= blk_hi - p.window);
    if (edge) {
      // each row sees the columns lo .. hi of this tile (relative to j0):
      // keys before Lk, at or before its position when causal, and after
      // its position - window
      int hi0 = p.Lk - 1 - j0, hi1 = hi0, lo0 = 0, lo1 = 0;
      if (p.causal) {
        hi0 = min(hi0, pos0 - j0);
        hi1 = min(hi1, pos1 - j0);
      }
      if (p.window > 0) {
        lo0 = pos0 - p.window + 1 - j0;
        lo1 = pos1 - p.window + 1 - j0;
      }
      const int lc = 2 * (lane % 4);
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int c = 8 * (i / 4) + (i % 2) + lc;
        const bool vis = (i / 2) % 2 ? (c >= lo1 && c <= hi1)
                                     : (c >= lo0 && c <= hi0);
        if (!vis) sc[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      if ((i / 2) % 2)
        mx1 = fmaxf(mx1, sc[i]);
      else
        mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // scale > 0, so the max of the scaled scores is the scaled max
    const float n0 = fmaxf(m0, mx0 * scale_log2);
    const float n1 = fmaxf(m1, mx1 * scale_log2);
    // nothing visible yet: the accumulators are still 0, keep them
    const float corr0 = n0 == -INFINITY ? 1.f : ex2(m0 - n0);
    const float corr1 = n1 == -INFINITY ? 1.f : ex2(m1 - n1);
    const float base0 = n0 == -INFINITY ? 0.f : n0;
    const float base1 = n1 == -INFINITY ? 0.f : n1;
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float base = r % 2 ? base1 : base0;
        pa[kk][r] = pack2<T>(ex2(fmaf(sc[i], scale_log2, -base)),
                             ex2(fmaf(sc[i + 1], scale_log2, -base)));
      }
    }
    // O and l now hold every tile before t: rescale them to m(t)
#pragma unroll
    for (int i = 0; i < DI / 2; ++i) o[i] *= (i / 2) % 2 ? corr1 : corr0;
    lacc[0] *= corr0;
    lacc[1] *= corr0;
    lacc[2] *= corr1;
    lacc[3] *= corr1;
  }

  // epilogue: O / l through the Q tile (every read of Q is complete once
  // all four warps pass the barrier), in the same swizzled layout, then
  // 16-byte rows of the model layout
  const float l0 = lacc[0], l1 = lacc[2];
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  __syncthreads();
  unsigned char* qbytes = reinterpret_cast<unsigned char*>(sQ);
#pragma unroll
  for (int i = 0; i < DI / 2; i += 2) {
    const int rr = warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int c = 8 * (i / 4) + 2 * (lane % 4);
    const float inv = (i / 2) % 2 ? inv1 : inv0;
    const int off = (c / kFhAtom) * kFhBQ * 128 + rr * 128 +
                    ((((c % kFhAtom) / 8) ^ (rr % 8)) * 16) + (c % 8) * 2;
    *reinterpret_cast<uint32_t*>(qbytes + off) =
        pack2<T>(o[i] * inv, o[i + 1] * inv);
  }
  __syncthreads();
  constexpr int kChunks = DI / 8;  // 16-byte pieces of a row
  for (int v = tid; v < kFhBQ * kChunks; v += kFhThreads) {
    const int rr = v / kChunks, ch = v % kChunks;
    const int qrow = q0 + rr;
    if (ch * 8 >= p.D || qrow >= p.Lq) continue;
    const int off =
        (ch / 8) * kFhBQ * 128 + rr * 128 + (((ch % 8) ^ (rr % 8)) * 16);
    *reinterpret_cast<uint4*>(
        out + (((long long)b * p.Lq + qrow) * p.Hq + h) * p.D + ch * 8) =
        *reinterpret_cast<const uint4*>(qbytes + off);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links without -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tensor map over one of q, k, v in the model layout (B, S, H, D), read
// as the 4-d tensor (D, H, S, B) with element strides (1, sh, ss, sb); a
// box is 64 columns of `rows` rows of one head. A dimension of extent 1
// gets the stride a contiguous tensor would have, whatever the caller's.
static int make_map(CUtensorMap* map, const void* base,
                    CUtensorMapDataType type, int D, int H, int S, int B,
                    long long sh, long long ss, long long sb, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (H == 1) sh = D;
  if (S == 1) ss = (long long)H * sh;
  if (B == 1) sb = (long long)S * ss;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  for (cuuint64_t st : strides)
    if (st % 16) return (int)cudaErrorInvalidValue;
  if (!aligned16(base)) return (int)cudaErrorInvalidValue;
  const cuuint32_t box[4] = {kFhAtom, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, type, 4, const_cast<void*>(base), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, int DI, int kBK>
static int launch_hopper(const void* q, const void* k, const void* v,
                         void* out, const FaDims& d, cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, type, d.D, d.Hq, d.Lq, d.B, d.sqh, d.sqs, d.sqb,
                     kFhBQ);
  if (!err)
    err = make_map(&mk, k, type, d.D, d.Hkv, d.Lk, d.B, d.skh, d.sks, d.skb,
                   kBK);
  if (!err)
    err = make_map(&mv, v, type, d.D, d.Hkv, d.Lk, d.B, d.svh, d.svs, d.svb,
                   kBK);
  if (err) return err;
  if ((d.Lq + kFhBQ - 1) / kFhBQ > 65535) return (int)cudaErrorInvalidValue;
  auto kern = flash_attention_wgmma_kernel<T, DI, kBK>;
  constexpr int smem = FhSmem<DI, kBK>::kTotal;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(d.Hq, d.B, (d.Lq + kFhBQ - 1) / kFhBQ);
  kern<<<grid, kFhThreads, smem, stream>>>(mq, mk, mv, static_cast<T*>(out),
                                           d);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_16bit(const void* q, const void* k, const void* v,
                        void* out, const FaDims& d, cudaStream_t stream) {
  if (d.D > 64) return launch_hopper<T, 128, 64>(q, k, v, out, d, stream);
  if (d.Lk <= kFhShortLk)
    return launch_hopper<T, 64, 64>(q, k, v, out, d, stream);
  return launch_hopper<T, 64, 128>(q, k, v, out, d, stream);
}

// ---------------------------------------------------------------------------
// f32: three-part bf16 operands through wmma, staged in shared memory

constexpr int kFaWarps = 4;
constexpr int kFaBQ = kFaWarps * kTile;   // query rows per block
constexpr int kFaBK = 64;                 // key rows per tile
constexpr int kFaThreads = kFaWarps * 32;
// Row padding of the shared-memory tiles: rows a multiple of 32 banks apart
// would send every row of a wmma fragment, and every softmax lane, to the
// same banks. 4 floats shift an f32 row by 4 banks, 8 halves a 16-bit row
// by 4. f32 inputs stage three unpadded bf16 parts, so that D = 128 still
// fits in a block's shared memory.
constexpr int kFaPadF = 4;
constexpr int kFaPadH = 8;
constexpr int kFaLdS = kFaBK + kFaPadF;   // scores
constexpr int kFaLdP = kFaBK + kFaPadH;   // probabilities

__host__ __device__ constexpr int fa_ld_qkv(int D, int parts) {
  return parts == 1 ? D + kFaPadH : D;
}


template <typename OT>
inline size_t fa_smem_bytes(int D, int parts) {
  const size_t ld = fa_ld_qkv(D, parts);
  return sizeof(float) * ((size_t)kFaBQ * kFaLdS +
                          (size_t)kFaBQ * (D + kFaPadF) +
                          (size_t)kFaBQ * kTile) +
         sizeof(OT) * parts *
             ((size_t)kFaBQ * ld + 2 * (size_t)kFaBK * ld +
              (size_t)kFaBQ * kFaLdP);
}

// s[plane * p + idx] = part p of v (one part: v in the operand type)
template <typename OT, int PARTS>
__device__ __forceinline__ void put_f32(OT* s, int plane, int idx, float v) {
  if constexpr (PARTS == 1) {
    s[idx] = from_f32<OT>(v);
  } else {
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    const float r = v - __bfloat162float(hi);
    const __nv_bfloat16 mid = __float2bfloat16_rn(r);
    s[idx] = hi;
    s[plane + idx] = mid;
    s[2 * plane + idx] = __float2bfloat16_rn(r - __bfloat162float(mid));
  }
}

// Stage rows [0, nrows) x [0, D) of a strided (rows, D) slice into s (row
// stride ld) as tensor-core operands; rows at or past `valid` are zero.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base,
                                           long long row_stride, int valid,
                                           int nrows, int D, int ld,
                                           typename Operand<T>::type* s,
                                           int tid) {
  using OT = typename Operand<T>::type;
  constexpr int PARTS = Operand<T>::parts;
  const int plane = nrows * ld;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const int per_row = D / V;
    for (int i = tid; i < nrows * per_row; i += kFaThreads) {
      const int r = i / per_row, c = (i % per_row) * V;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid)
        raw = *reinterpret_cast<const uint4*>(base + r * row_stride + c);
      if constexpr (PARTS == 1) {
        *reinterpret_cast<uint4*>(s + r * ld + c) = raw;
      } else {
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j)
          put_f32<OT, PARTS>(s, plane, r * ld + c + j, to_f32(v[j]));
      }
    }
  } else {
    for (int i = tid; i < nrows * D; i += kFaThreads) {
      const int r = i / D, c = i % D;
      const float v = r < valid ? to_f32(base[r * row_stride + c]) : 0.f;
      put_f32<OT, PARTS>(s, plane, r * ld + c, v);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kFaThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           FaDims d) {
  using OT = typename Operand<T>::type;
  constexpr int PARTS = Operand<T>::parts;
  extern __shared__ __align__(128) unsigned char fa_smem[];
  const int D = d.D;
  const int ldq = fa_ld_qkv(D, PARTS), ldo = D + kFaPadF;
  float* sS = reinterpret_cast<float*>(fa_smem);  // (BQ, BK) scores
  float* sO = sS + kFaBQ * kFaLdS;                // (BQ, D) accumulators
  float* sL = sO + kFaBQ * ldo;                   // (BQ, 16) l, replicated
  OT* sQ = reinterpret_cast<OT*>(sL + kFaBQ * kTile);  // PARTS x (BQ, D)
  OT* sK = sQ + PARTS * kFaBQ * ldq;                   // PARTS x (BK, D)
  OT* sV = sK + PARTS * kFaBK * ldq;                   // PARTS x (BK, D)
  OT* sP = sV + PARTS * kFaBK * ldq;                   // PARTS x (BQ, BK)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kFaBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (d.Hq / d.Hkv);
  const int offs = d.Lk - d.Lq;
  const int q_valid = min(kFaBQ, d.Lq - q0);

  stage_rows<T, VEC>(q + b * d.sqb + (long long)q0 * d.sqs + h * d.sqh,
                     d.sqs, q_valid, kFaBQ, D, ldq, sQ, tid);
  for (int i = tid; i < kFaBQ * ldo; i += kFaThreads) sO[i] = 0.f;
  for (int i = tid; i < kFaBQ * kTile; i += kFaThreads) sL[i] = 0.f;
  __syncthreads();  // Q and the zeroed rows are every warp's from here on

  // KV tiles that any of this block's rows can see
  const int q_lo = q0 + offs, q_hi = q0 + q_valid - 1 + offs;
  const int kv_end = d.causal ? min(d.Lk, q_hi + 1) : d.Lk;
  const int kv_begin =
      d.window > 0 ? (max(0, q_lo - d.window + 1) / kFaBK) * kFaBK : 0;

  // softmax lanes: two per row, each over half the tile's columns, which
  // every lane walks from its own starting column so that the 32 lanes
  // read and write 32 different banks at each step
  const int row = lane / 2, half = lane % 2;
  const int wrow = warp * kTile + row;      // row within the block
  const int qpos = q0 + wrow + offs;        // its position in key space
  float m = -INFINITY;

  const T* kb = k + b * d.skb + hk * d.skh;
  const T* vb = v + b * d.svb + hk * d.svh;
  FragB<OT> ones;
  wmma::fill_fragment(ones, from_f32<OT>(1.f));

  for (int j0 = kv_begin; j0 < kv_end; j0 += kFaBK) {
    __syncthreads();  // every warp is done with the previous K, V tiles
    const int k_valid = min(kFaBK, d.Lk - j0);
    stage_rows<T, VEC>(kb + (long long)j0 * d.sks, d.sks, k_valid, kFaBK, D,
                       ldq, sK, tid);
    stage_rows<T, VEC>(vb + (long long)j0 * d.svs, d.svs, k_valid, kFaBK, D,
                       ldq, sV, tid);
    __syncthreads();

    // 1. S = Q K^T for this warp's 16 rows
    for (int n = 0; n < kFaBK / kTile; ++n) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D; kk += kTile) {
#pragma unroll
        for (int pa = 0; pa < PARTS; ++pa) {
          FragA<OT> fa;
          wmma::load_matrix_sync(
              fa, sQ + pa * kFaBQ * ldq + warp * kTile * ldq + kk, ldq);
#pragma unroll
          for (int pb = 0; pb < PARTS - pa; ++pb) {
            wmma::fragment<wmma::matrix_b, kTile, kTile, kTile, OT,
                           wmma::col_major>
                fb;
            wmma::load_matrix_sync(
                fb, sK + pb * kFaBK * ldq + n * kTile * ldq + kk, ldq);
            wmma::mma_sync(acc, fa, fb, acc);
          }
        }
      }
      wmma::store_matrix_sync(sS + warp * kTile * kFaLdS + n * kTile, acc,
                              kFaLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // 2. online softmax, masks before exp
    float* srow = sS + wrow * kFaLdS;
    constexpr int kHalf = kFaBK / 2;
    float tmax = -INFINITY;
    for (int j = 0; j < kHalf; ++j) {
      const int c = half * kHalf + ((j + lane) & (kHalf - 1));
      const int kpos = j0 + c;
      const bool vis = kpos < d.Lk && (!d.causal || kpos <= qpos) &&
                       (d.window <= 0 || kpos > qpos - d.window);
      const float s = vis ? srow[c] * d.scale : -INFINITY;
      srow[c] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    // nothing visible yet: the accumulators are still 0, keep them
    const float corr = m_new == -INFINITY ? 1.f : expf(m - m_new);
    const int pplane = kFaBQ * kFaLdP;
    for (int j = 0; j < kHalf; ++j) {
      const int c = half * kHalf + ((j + lane) & (kHalf - 1));
      const float s = srow[c];
      const float p = s == -INFINITY ? 0.f : expf(s - m_new);
      put_f32<OT, PARTS>(sP, pplane, wrow * kFaLdP + c, p);
    }
    m = m_new;
    const int hd = D / 2;
    for (int j = 0; j < hd; ++j)
      sO[wrow * ldo + half * hd + (j + lane) % hd] *= corr;
    for (int j = 0; j < kTile / 2; ++j)
      sL[wrow * kTile + half * (kTile / 2) + ((j + lane) & 7)] *= corr;
    __syncwarp();

    // 3. O += P V and l += P @ 1 for this warp's rows
    for (int n = 0; n < D / kTile; ++n) {
      FragC acc;
      float* o = sO + warp * kTile * ldo + n * kTile;
      wmma::load_matrix_sync(acc, o, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < kFaBK; kk += kTile) {
#pragma unroll
        for (int pa = 0; pa < PARTS; ++pa) {
          FragA<OT> fa;
          wmma::load_matrix_sync(
              fa, sP + pa * pplane + warp * kTile * kFaLdP + kk, kFaLdP);
#pragma unroll
          for (int pb = 0; pb < PARTS - pa; ++pb) {
            FragB<OT> fb;
            wmma::load_matrix_sync(
                fb, sV + pb * kFaBK * ldq + kk * ldq + n * kTile, ldq);
            wmma::mma_sync(acc, fa, fb, acc);
          }
        }
      }
      wmma::store_matrix_sync(o, acc, ldo, wmma::mem_row_major);
    }
    {
      FragC acc;
      float* l = sL + warp * kTile * kTile;
      wmma::load_matrix_sync(acc, l, kTile, wmma::mem_row_major);
      for (int kk = 0; kk < kFaBK; kk += kTile) {
#pragma unroll
        for (int pa = 0; pa < PARTS; ++pa) {
          FragA<OT> fa;
          wmma::load_matrix_sync(
              fa, sP + pa * pplane + warp * kTile * kFaLdP + kk, kFaLdP);
          wmma::mma_sync(acc, fa, ones, acc);
        }
      }
      wmma::store_matrix_sync(l, acc, kTile, wmma::mem_row_major);
    }
  }
  __syncwarp();

  // O / l in the model layout; l > 0 guard: a row that saw nothing is 0
  for (int r = 0; r < kTile; ++r) {
    const int br = warp * kTile + r;
    if (br >= q_valid) break;
    const float l = sL[br * kTile];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + (((long long)b * d.Lq + q0 + br) * d.Hq + h) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = from_f32<T>(sO[br * ldo + c] * inv);
  }
}

static int launch_f32(const void* q, const void* k, const void* v,
                      void* out, const FaDims& d, cudaStream_t stream) {
  using T = float;
  using OT = typename Operand<T>::type;
  constexpr int V = 16 / sizeof(T);
  const bool vec = aligned16(q) && aligned16(k) && aligned16(v) &&
                   d.sqs % V == 0 && d.sks % V == 0 && d.svs % V == 0 &&
                   d.sqb % V == 0 && d.skb % V == 0 && d.svb % V == 0 &&
                   d.sqh % V == 0 && d.skh % V == 0 && d.svh % V == 0;
  const size_t smem = fa_smem_bytes<OT>(d.D, Operand<T>::parts);
  auto kern = vec ? flash_attention_kernel<T, true>
                  : flash_attention_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((d.Lq + kFaBQ - 1) / kFaBQ, d.Hq, d.B);
  kern<<<grid, kFaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), d);
  return (int)cudaGetLastError();
}

}  // namespace rt

// Dynamic shared memory of one block of the kernel that takes head dim D
// and Lk keys in this dtype.
extern "C" long long flash_attention_smem_bytes(int D, int Lk, int dtype) {
  if (dtype == rt::kF32)
    return (long long)rt::fa_smem_bytes<__nv_bfloat16>(D, 3);
  if (D > 64) return rt::FhSmem<128, 64>::kTotal;
  return Lk <= rt::kFhShortLk ? rt::FhSmem<64, 64>::kTotal
                              : rt::FhSmem<64, 128>::kTotal;
}

// q (B, Lq, Hq, D), k/v (B, Lk, Hkv, D) with their strides (the last dim
// contiguous), out (B, Lq, Hq, D) contiguous, all of one dtype. D a
// multiple of 16 and at most 128; Hq a multiple of Hkv; window 0 for none.
// f16 / bf16 also need 16-byte aligned q, k, v and strides that are
// multiples of 16 bytes (TMA's rule; the Python wrapper copies a view that
// breaks it). The tiles are the kernels' own.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int B, int Lq, int Lk, int Hq, int Hkv, int D, int causal, int window,
    float scale, long long sqb, long long sqs,
    long long sqh, long long skb, long long sks, long long skh,
    long long svb, long long svs, long long svh, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv ||
      D < 16 || D % 16 || D > rt::kFaMaxD || window < 0 || Hq > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const rt::FaDims d{B,   Lq,  Lk,  Hq,  Hkv, D,   window, causal != 0,
                     scale, sqb, sqs, sqh, skb, sks, skh,    svb, svs, svh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rt::kF32:
      return rt::launch_f32(q, k, v, out, d, st);
    case rt::kF16:
      return rt::launch_16bit<__half>(q, k, v, out, d, st);
    case rt::kBF16:
      return rt::launch_16bit<__nv_bfloat16>(q, k, v, out, d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
