// Blocked (flash) attention with GQA, causal and sliding-window masks.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention (and its
// Pallas-Triton twin src/repro/kernels/triton/flash_attention.py::
// triton_flash_attention). Same function: softmax(Q K^T * scale + mask) V
// with an online softmax over KV tiles (running max m, sum l, f32
// accumulator), query head h reading KV head h / (Hq / Hkv), query rows
// offset by Lk - Lq so that the sequence ends align, whole KV tiles skipped
// outside the causal and window bounds, and l > 0 guarding the final
// division so that a row that sees nothing writes 0.
//
// Bound on an H100: at the serving prefill (B=4, L=512, 32/8 heads of 64,
// bf16) bytes: about 21 MB against 4.3 GFLOP, 6.3 us at 3.35 TB/s. At one
// sequence of 4096 operations: 69 GFLOP causal, 70 us at 989 TFLOP/s. This
// first version stages every product through shared memory with wmma
// fragments, so it is bound by that traffic and the softmax pass, not by
// either floor; wgmma with register-resident accumulators and TMA loads
// are later work.
//
// Design: one thread block per (query tile of 64 rows, query head, batch),
// four warps, each owning 16 query rows. The TPU kernel's sequential KV
// grid axis becomes a loop inside the block over KV tiles of 64 rows, which
// all four warps share in shared memory. Per tile a warp
//   1. computes its 16 x 64 block of S = Q K^T on the tensor cores
//      (16x16x16 wmma, f32 accumulation) into shared memory;
//   2. runs the online softmax on it with two lanes per row: masks (causal,
//      window, keys past Lk) before exp, keeps m in a register, writes
//      P = exp(S - m) as tensor-core operands and rescales its rows of the
//      accumulators by exp(m_old - m);
//   3. adds P V into its f32 accumulator rows, and P @ 1 into the l
//      accumulator, both on the tensor cores: l is the paper's P-matrix
//      row sum, as in the TPU kernel, and taken from the same rounded P as
//      the numerator, so the normalisation matches the products it divides.
// f32 inputs do not go through TF32: every f32 operand is split into three
// bf16 parts (hi + mid + lo, as in tcu_reduce/tcu_scan) and a product of two
// split operands keeps the six part products whose order is at most 2^-16,
// which leaves an error near f32 rounding. f16 and bf16 go in as they are
// (P is rounded to the input type, as flash attention does).
// Q, K and V are read in the model layout (B, S, H, D) through their
// strides and the output is written in that layout, so no transposed or
// head-repeated copy exists. Tail tiles are zero-filled in shared memory,
// keys at or past Lk are masked and rows at or past Lq are not stored, so
// any length runs with no padding and no fallback. D must be a multiple of
// 16 and at most 128; the launcher refuses anything else.
#include "tcu_tile.cuh"

namespace rt {

constexpr int kFaWarps = 4;
constexpr int kFaBQ = kFaWarps * kTile;   // query rows per block
constexpr int kFaBK = 64;                 // key rows per tile
constexpr int kFaThreads = kFaWarps * 32;
constexpr int kFaMaxD = 128;
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

struct FaDims {
  int B, Lq, Lk, Hq, Hkv, D, window;  // window 0: none
  int causal;
  float scale;
  long long sqb, sqs, sqh;            // q (B, Lq, Hq, D), d contiguous
  long long skb, sks, skh;            // k (B, Lk, Hkv, D)
  long long svb, svs, svh;            // v (B, Lk, Hkv, D)
};

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

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  const FaDims& d, cudaStream_t stream) {
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

// q (B, Lq, Hq, D), k/v (B, Lk, Hkv, D) with their strides (the last dim
// contiguous), out (B, Lq, Hq, D) contiguous, all of one dtype. D a
// multiple of 16 and at most 128; Hq a multiple of Hkv; window 0 for none.
// The tiles are the kernel's own (kFaBQ x kFaBK = 64 x 64).
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
      return rt::launch<float>(q, k, v, out, d, st);
    case rt::kF16:
      return rt::launch<__half>(q, k, v, out, d, st);
    case rt::kBF16:
      return rt::launch<__nv_bfloat16>(q, k, v, out, d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
