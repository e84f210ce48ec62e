// Matrix products: matmul (f32 / bf16 / f16 operands, fp32 accumulation) and
// matmul_int8 (int8 operands, exact int32 accumulation, optional
// requantization).
//
// Replaces: repro/kernels/matmul.py::_matmul_kernel (wrapper `matmul`) and
// ::_matmul_int8_kernel (wrapper `matmul_int8`). There the K axis is the
// innermost, sequential grid axis and the accumulator lives in scratch
// memory across grid steps, zeroed on the first step and written out on the
// last. Here blocks run in no order, so the K loop sits inside the block:
// the code before the loop is the first-step init, the code after it the
// last-step epilogue, and the accumulator is in registers.
//
// matmul takes one of four routes, picked by the source from the operand
// type and the rows M (repro_matmul_route); matmul_int8 one of two (below):
//
//  0 `skinny_mma`, bf16/f16 with M <= 16: the serving head, a(slots, 2048)
//    @ b(2048, 32000). Each element of b is used M times, far below the
//    card's ridge of ~295 operations a byte, so the bound is reading b once
//    (131 MB in bf16: 0.039 ms at 3.35 TB/s). The product runs on the
//    tensor cores with the operands swapped, out^T (16 n x 8 m) = b^T (16 n
//    x 16 k) . a^T (16 k x 8 m), one mma.sync m16n8k16 per step: b^T's A
//    fragments come from row-major b tiles by ldmatrix.x4.trans, a^T is the
//    col-major B operand, which is a's own row-major layout (ldmatrix).
//    One block per SM (the launcher asks the device), each taking an equal
//    share of N in units of 16 columns (up to 256), so no SM idles and none
//    takes two shares; its 8 warps own 32 columns each. b streams through
//    shared memory in a ring of kSkStages tiles of kSkBK rows, filled by
//    16-byte cp.async three tiles ahead (48 KB in flight an SM); a's 16 x
//    kSkBK tile travels with each b tile, so any K fits. The transposed
//    accumulator is staged in shared memory and written out in rows.
//  1 `tiled_mma`, bf16/f16 with M > 16: the paper's MATMUL (256^2, 512^2)
//    and the model's projections, bound by operations at large sizes.
//    Block tiles of 128 x 128 x 64 in a ring of 3 cp.async stages, eight
//    warps of 64 x 32, ldmatrix (.trans for b), mma.sync with fp32
//    accumulators; where those tiles would not give every SM one, 64 x 64 x
//    32 tiles of four warps.
//  2 `skinny_fma`, float32 with M <= 16: the first kernel, kept: 8 rows of a
//    by 128 columns a block, b read straight into registers (16 bytes a
//    load, kU rows ahead), fp32 FMAs; K slices summed in a fixed order.
//  3 `tiled_fma`, float32 with M > 16: no tensor cores (TF32 would round the
//    operands; the port keeps fp32 products). A register-blocked CUDA-core
//    GEMM: 128 x 128 block tiles (64 x 64 where those would not fill the
//    SMs), 8 x 8 (4 x 4) outputs a thread, a and b staged in double-buffered
//    shared memory (a transposed) from registers loaded one tile ahead,
//    16-byte shared loads; b is read once per 128 rows, not per 8.
// Ragged edges are masked in the kernels: tiles past M, N or K are filled
// with zeros by the copy (cp.async with a source size of 0) and not stored;
// where N, K or a base address does not allow 16-byte copies, that operand
// is staged element by element into the same tiles.
//
// matmul_int8 takes one of two routes, picked by the source from the rows M
// (repro_matmul_int8_route), both on the int8 tensor cores (mma.sync
// m16n8k32 s8 x s8 -> s32, no .satfinite: int32 sums wrap as the
// reference's accumulator does), with the epilogue of the reference (add
// half with int32 wrap-around, arithmetic shift, saturate only an int8
// output) applied to each accumulator as it is stored:
//
//  0 `skinny_imma`, M <= 16: the int8 logits heads, a(slots, 2048 | 3584)
//    @ b(.., 32000 | 50304). Bound by reading b once (65.5 MB at
//    tinyllama-1.1b's head: 0.0196 ms at 3.35 TB/s), so it is skinny_mma
//    in int8: out^T = b^T . a^T, blocks with equal shares of 16-column
//    units (at least one block an SM), b streamed through a cp.async ring
//    of kI8SkStages tiles of kI8SkBK k x kI8SkBN columns, a's rows the B
//    operand by plain ldmatrix (16 bytes a row are 32 int8 of k). Shares
//    of at most 128 columns, four warps of 32 (two or three blocks an SM
//    at the heads), were faster than skinny_mma's 256 columns of eight
//    warps, and than 64-column shares or deeper rings
//    (tools/torch_kernel_variants.py --mm qk:...). What differs from
//    bf16 is b^T: the A operand wants four consecutive k of one column in
//    a 32-bit register, b is row-major, and ldmatrix's 8-bit transposing
//    shapes need sm_100; so b^T comes from 32-bit shared loads of four rows
//    and a 4x4 byte transpose (__byte_perm). The four columns one word
//    holds feed rows gr and gr + 8 of two m16 tiles, and the epilogue
//    stores each thread's four adjacent columns as one vector. The tile's
//    16-byte chunks are XOR-swizzled by row so that the four rows a quad
//    reads hit distinct banks (b_chunk).
//  1 `tiled_imma`, M > 16: the paper's int8 MATMUL (256^3, 512^3) and
//    projection-sized products, bound by operations at large sizes (1,979
//    TOP/s). Block tiles of 128 x 128 x 64 in a ring of 4 cp.async
//    stages, eight warps of 64 x 32, two blocks an SM (64 x 64 x 64 tiles
//    of four warps where the large ones would not give every SM one),
//    ldmatrix for a, the same byte transpose for b (a word of four columns
//    feeds four n8 tiles, so a thread ends with 8 adjacent columns of a
//    row), int32 accumulators.
// Ragged M, N and K are masked by zero fill as in the float routes; where
// N, K or a base address does not allow 16-byte copies, that operand is
// staged byte by byte (stage8).
//
// C interface (loaded with ctypes): each function launches on the given
// stream, does not synchronise, allocates nothing and returns the launch's
// cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 8;    // rows of a (and of out) per block
constexpr int kBN = 128;  // columns of b (and of out) per block
constexpr int kU = 8;     // skinny_fma: rows of b loaded ahead per thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// Sum the K slices of one block and hand each output element to `store`.
// `acc` is this thread's kBM x VEC partial tile for columns
// [tn * VEC, tn * VEC + VEC) of the block; threads whose tn agree hold
// different K slices of the same columns. `red` is kWarps * kBM * kBN words
// of shared memory that no thread reads any more in another role.
template <typename Acc, int VEC, typename Store>
__device__ __forceinline__ void reduce_slices(Acc (&acc)[kBM][VEC], Acc* red, Store store) {
  constexpr int TN = kBN / VEC;  // threads along N; K slices inside a warp: 32 / TN
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int off = TN; off < 32; off <<= 1) {
#pragma unroll
    for (int m = 0; m < kBM; ++m) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
    }
  }
  if (lane < TN) {  // lane == tn here: these lanes hold their warp's sum
#pragma unroll
    for (int m = 0; m < kBM; ++m) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) red[(warp * kBM + m) * kBN + lane * VEC + c] = acc[m][c];
    }
  }
  __syncthreads();
  for (int o = tid; o < kBM * kBN; o += kThreads) {
    const int m = o / kBN, c = o % kBN;
    Acc s = red[m * kBN + c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[(w * kBM + m) * kBN + c];
    store(m, c, s);
  }
}

// ---------------------------------------------------------------------------
// route 2 (skinny_fma): float32 operands, M <= 16, fp32 FMAs, one cast at the end
// ---------------------------------------------------------------------------

template <typename TIn, int VEC>
__device__ __forceinline__ void unpack(const uint4& raw, float (&bv)[VEC]) {
  const TIn* e = reinterpret_cast<const TIn*>(&raw);
#pragma unroll
  for (int c = 0; c < VEC; ++c) bv[c] = to_float(e[c]);
}

// acc[m][:] += a[m][k] * b[k][:] for the kBM rows; a_k points at a[0][k] in
// shared memory, rows `stride` apart (a broadcast read: a warp shares k)
template <int VEC>
__device__ __forceinline__ void fma_rows(float (&acc)[kBM][VEC], const float* a_k, int stride,
                                         const float (&bv)[VEC]) {
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
    const float av = a_k[m * stride];
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = fmaf(av, bv[c], acc[m][c]);
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
matmul_fma_skinny(const TIn* __restrict__ a, const TIn* __restrict__ b, TOut* __restrict__ out,
              int M, int K, int N, int vec_ok) {
  constexpr int VEC = 16 / sizeof(TIn);  // columns per thread: one 16-byte load
  constexpr int TN = kBN / VEC;          // threads along N
  constexpr int KS = kThreads / TN;      // K slices per block
  constexpr int BKC = 512;               // k per staged chunk of a
  static_assert(kBM * BKC <= kWarps * kBM * kBN, "a chunk must fit the reduction buffer");
  __shared__ __align__(16) float smem[kWarps * kBM * kBN];  // a chunk [kBM][BKC], later the slices
  float* As = smem;

  const int tid = threadIdx.x;
  const int tn = tid % TN, ks = tid / TN;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN + tn * VEC;

  float acc[kBM][VEC];
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0.f;
  }

  for (int kc = 0; kc < K; kc += BKC) {
    const int klen = min(BKC, K - kc);
    __syncthreads();  // the previous chunk has been read by everyone
    for (int i = tid; i < kBM * BKC; i += kThreads) {
      const int m = i / BKC, kk = i % BKC;
      float v = 0.f;
      if (row0 + m < M && kk < klen) v = to_float(a[(size_t)(row0 + m) * K + kc + kk]);
      As[m * BKC + kk] = v;
    }
    __syncthreads();
    if (col0 < N) {
      int kk = ks;
      if (vec_ok) {
        // kU rows of this K slice at a time: all kU 16-byte loads are issued
        // before the first is used, so each thread keeps kU loads in flight
        for (; kk + (kU - 1) * KS < klen; kk += kU * KS) {
          uint4 raw[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            raw[u] = __ldg(reinterpret_cast<const uint4*>(b + (size_t)(kc + kk + u * KS) * N + col0));
          }
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            float bv[VEC];
            unpack<TIn, VEC>(raw[u], bv);
            fma_rows<VEC>(acc, As + kk + u * KS, BKC, bv);
          }
        }
      }
      // the rest of the chunk — all of it where 16-byte loads do not fit
      for (; kk < klen; kk += KS) {
        const TIn* brow = b + (size_t)(kc + kk) * N;
        float bv[VEC];
        if (vec_ok) {  // N % VEC == 0 and col0 % VEC == 0: the whole vector is in range
          unpack<TIn, VEC>(__ldg(reinterpret_cast<const uint4*>(brow + col0)), bv);
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) bv[c] = (col0 + c < N) ? to_float(brow[col0 + c]) : 0.f;
        }
        fma_rows<VEC>(acc, As + kk, BKC, bv);
      }
    }
  }
  __syncthreads();  // the last chunk has been read: smem changes role

  const int colb = blockIdx.x * kBN;
  reduce_slices<float, VEC>(acc, smem, [&](int m, int c, float s) {
    if (row0 + m < M && colb + c < N) out[(size_t)(row0 + m) * N + colb + c] = from_float<TOut>(s);
  });
}

// ---------------------------------------------------------------------------
// routes 0-1 (skinny_mma, tiled_mma): bf16 / f16 operands on the tensor cores
// ---------------------------------------------------------------------------

using mma_sm90::cp_async16;
using mma_sm90::cp_async_commit;
using mma_sm90::cp_async_wait;
using mma_sm90::ldmatrix_x4;
using mma_sm90::ldmatrix_x4_trans;
using mma_sm90::mma_16816;

constexpr int kSkM = 16;          // rows of a the skinny route takes (M <= kSkM)
constexpr int kSkBN = 256;        // most columns of b a block takes (16 a unit)
constexpr int kSkBK = 32;         // k per stage of the ring
constexpr int kSkStages = 4;      // stages of the ring (kSkStages - 1 in flight)
constexpr int kSkThreads = kSkBN;  // a warp for each 32 columns
constexpr int kSkLdB = kSkBN + 8; // padded rows: ldmatrix reads 8 rows without bank conflicts
constexpr int kSkLdA = kSkBK + 8;
constexpr size_t kSkSmem = (size_t)kSkStages * (kSkBK * kSkLdB + kSkM * kSkLdA) * 2;
static_assert(kSkBN % 32 == 0 && kSkBK % 16 == 0, "skinny tile");
static_assert(kSkM * (kSkBN + 4) * 4 <= kSkSmem, "the transpose buffer must fit the ring");

// tiled_mma block tiles (rows x columns x k, warp tile, ring stages): the
// large one where its tiles fill the card, the small one below that
constexpr int kTBM = 128, kTBN = 128, kTBK = 64, kTWM = 64, kTWN = 32, kTStages = 3, kTMinBlocks = 2;
constexpr int kSBM = 64, kSBN = 64, kSBK = 32, kSWM = 32, kSWN = 32, kSStages = 4, kSMinBlocks = 4;
constexpr int kSMs = 132;         // an H100's SMs, where the device cannot be asked

template <int BM, int BN, int BK, int STAGES>
constexpr size_t tiled_smem() {
  return (size_t)STAGES * (BM * (BK + 8) + BK * (BN + 8)) * 2;
}

constexpr int kGridY = 65535;     // gridDim.y limit: row tiles of a launch

// rows x 8-element chunks of a row-major 16-bit array with row stride lds,
// from (r0, c0), into dst with row stride ld; rows from rows_total and
// columns from c_end on read as zero. vec: 16-byte cp.async, zero-filled
// past the edges (lds and c_end multiples of 8 and a 16-byte aligned base,
// so a chunk is wholly inside or outside); else element by element.
template <int ROWS, int COLS, int NT>
__device__ __forceinline__ void stage16(uint16_t* dst, int ld, const uint16_t* src, int lds, int r0,
                                        int rows_total, int c0, int c_end, bool vec) {
  constexpr int CH = COLS / 8;
#pragma unroll
  for (int it = 0; it < (ROWS * CH + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (i >= ROWS * CH) break;
    const int r = i / CH, c = (i % CH) * 8;
    const int gr = r0 + r, gc = c0 + c;
    uint16_t* d = dst + r * ld + c;
    if (vec) {
      const bool full = gr < rows_total && gc < c_end;
      cp_async16(d, full ? src + (size_t)gr * lds + gc : src, full);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = (gr < rows_total && gc + e < c_end) ? src[(size_t)gr * lds + gc + e] : (uint16_t)0;
      }
    }
  }
}

template <typename T, typename TOut>
__global__ void __launch_bounds__(kSkThreads)
matmul_mma_skinny(const T* __restrict__ a, const T* __restrict__ b, TOut* __restrict__ out, int M, int K, int N,
                  int a_vec, int b_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Bs = reinterpret_cast<uint16_t*>(smem_raw);  // [kSkStages][kSkBK][kSkLdB]
  uint16_t* As = Bs + kSkStages * kSkBK * kSkLdB;         // [kSkStages][kSkM][kSkLdA]
  const uint16_t* a16 = reinterpret_cast<const uint16_t*>(a);
  const uint16_t* b16 = reinterpret_cast<const uint16_t*>(b);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // an equal share of the 16-column units for each block: gridDim.x is the
  // card's SM count (or more, up to kSkBN / 16 units a block)
  const int units = (N + 15) / 16;
  const int n0 = (int)((long long)blockIdx.x * units / gridDim.x) * 16;
  const int n_end = min(N, (int)((long long)(blockIdx.x + 1) * units / gridDim.x) * 16);
  const int ktiles = (K + kSkBK - 1) / kSkBK;
  const bool two_m = M > 8;  // rows 8..15 exist: the second n8 tile of out^T

  auto load = [&](int kt) {
    const int slot = kt % kSkStages, k0 = kt * kSkBK;
    stage16<kSkBK, kSkBN, kSkThreads>(Bs + slot * kSkBK * kSkLdB, kSkLdB, b16, N, k0, K, n0, n_end, b_vec);
    stage16<kSkM, kSkBK, kSkThreads>(As + slot * kSkM * kSkLdA, kSkLdA, a16, K, 0, M, k0, K, a_vec);
  };
#pragma unroll
  for (int s = 0; s < kSkStages - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }

  float acc[2][2][4];  // [16 columns of the warp's 32][8 rows of a][C fragment]
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][u][e] = 0.f;
    }
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kSkStages - 2>();
    __syncthreads();  // tile kt has landed for everyone; tile kt - 1 is read
    // refill the slot of tile kt - 1 now, so kSkStages - 1 tiles are in
    // flight while this one is multiplied
    if (kt + kSkStages - 1 < ktiles) load(kt + kSkStages - 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    const uint16_t* bs = Bs + (kt % kSkStages) * kSkBK * kSkLdB;
    const uint16_t* as = As + (kt % kSkStages) * kSkM * kSkLdA;
#pragma unroll
    for (int kk = 0; kk < kSkBK; kk += 16) {
      // a^T as the B operand: rows 0-7 of a in bf[0..1], rows 8-15 in bf[2..3]
      uint32_t bf[4];
      ldmatrix_x4(bf, as + (lane % 8 + (lane / 16) * 8) * kSkLdA + kk + ((lane / 8) % 2) * 8);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        // b^T (16 columns of b x 16 k) as the A operand, from b's k rows
        uint32_t af[4];
        ldmatrix_x4_trans(af, bs + (kk + lane % 8 + (lane / 16) * 8) * kSkLdB + warp * 32 + t * 16 +
                                  ((lane / 8) % 2) * 8);
        mma_16816<T>(acc[t][0], af, bf[0], bf[1]);
        if (two_m) mma_16816<T>(acc[t][1], af, bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it becomes the transpose buffer

  // out^T fragments -> Os[m][n] -> rows of out
  constexpr int LDO = kSkBN + 4;
  float* os = reinterpret_cast<float*>(smem_raw);
  const int gr = lane / 4, tq = lane % 4;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = warp * 32 + t * 16 + gr, m = u * 8 + 2 * tq;
      os[m * LDO + n] = acc[t][u][0];
      os[(m + 1) * LDO + n] = acc[t][u][1];
      os[m * LDO + n + 8] = acc[t][u][2];
      os[(m + 1) * LDO + n + 8] = acc[t][u][3];
    }
  }
  __syncthreads();
  for (int i = tid; i < M * kSkBN; i += kSkThreads) {
    const int m = i / kSkBN, c = i % kSkBN;
    if (n0 + c < n_end) out[(size_t)m * N + n0 + c] = from_float<TOut>(os[m * LDO + c]);
  }
}

// a pair of adjacent outputs (row, col), (row, col + 1); pair: both in range
// and the pair's address aligned for one store
template <typename TOut>
__device__ __forceinline__ void store2(TOut* out, size_t idx, float v0, float v1, bool pair, bool second) {
  if (pair) {
    if constexpr (sizeof(TOut) == 4) {
      *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
    } else {
      const uint32_t w = mma_sm90::pack2<TOut>(v0, v1);
      *reinterpret_cast<uint32_t*>(out + idx) = w;
    }
  } else {
    out[idx] = from_float<TOut>(v0);
    if (second) out[idx + 1] = from_float<TOut>(v1);
  }
}

// block tile BM x BN x BK, warps of WM x WN, a ring of STAGES, at least
// MINB blocks an SM (the register budget a thread gets)
template <typename T, typename TOut, int BM, int BN, int BK, int WM, int WN, int STAGES, int MINB>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MINB)
matmul_mma_tiled(const T* __restrict__ a, const T* __restrict__ b, TOut* __restrict__ out, int M, int K, int N,
                 int a_vec, int b_vec) {
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int LDA = BK + 8, LDB = BN + 8;
  constexpr int MI = WM / 16, NJ = WN / 8;  // m16 and n8 tiles of a warp
  static_assert(WN % 16 == 0 && BK % 16 == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* As = reinterpret_cast<uint16_t*>(smem_raw);  // [STAGES][BM][LDA]
  uint16_t* Bs = As + STAGES * BM * LDA;                  // [STAGES][BK][LDB]
  const uint16_t* a16 = reinterpret_cast<const uint16_t*>(a);
  const uint16_t* b16 = reinterpret_cast<const uint16_t*>(b);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  auto load = [&](int kt) {
    const int slot = kt % STAGES, k0 = kt * BK;
    stage16<BM, BK, NT>(As + slot * BM * LDA, LDA, a16, K, m0, M, k0, K, a_vec);
    stage16<BK, BN, NT>(Bs + slot * BK * LDB, LDB, b16, N, k0, K, n0, N, b_vec);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }

  float acc[MI][NJ][4];  // [m16 tile][n8 tile][C fragment]: the warp's WM x WN
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load(kt + STAGES - 1);  // the slot of tile kt - 1
    cp_async_commit();
    const uint16_t* as = As + (kt % STAGES) * BM * LDA + (wm * WM) * LDA;
    const uint16_t* bs = Bs + (kt % STAGES) * BK * LDB + wn * WN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4], bf[NJ / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldmatrix_x4(af[i], as + (i * 16 + lane % 16) * LDA + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j) {
        ldmatrix_x4_trans(bf[j], bs + (kk + lane % 16) * LDB + j * 16 + (lane / 16) * 8);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_16816<T>(acc[i][j], af[i], bf[j / 2][(j % 2) * 2], bf[j / 2][(j % 2) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

  const int gr = lane / 4, tq = lane % 4;
  const bool even = (N % 2) == 0;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * WM + i * 16 + gr + h * 8;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + wn * WN + j * 8 + 2 * tq;
        if (col >= N) continue;
        const bool second = col + 1 < N;
        store2<TOut>(out, (size_t)row * N + col, acc[i][j][2 * h], acc[i][j][2 * h + 1], even && second, second);
      }
    }
  }
}

template <typename T, typename TOut, int BM, int BN, int BK, int WM, int WN, int STAGES, int MINB>
int launch_mma_tiled(const T* a, const T* b, TOut* out, int M, int K, int N, int a_vec, int b_vec,
                     cudaStream_t stream) {
  constexpr size_t smem = tiled_smem<BM, BN, BK, STAGES>();
  static_assert(smem <= 232448, "tiled_mma ring exceeds shared memory");
  auto kernel = matmul_mma_tiled<T, TOut, BM, BN, BK, WM, WN, STAGES, MINB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, (BM / WM) * (BN / WN) * 32, smem, stream>>>(a, b, out, M, K, N, a_vec, b_vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// matmul_int8 (skinny_imma, tiled_imma): int8 operands on the int8 tensor
// cores, exact int32 accumulation, requantized at the end
// ---------------------------------------------------------------------------

// c += a b, one m16n8k32 product of s8 operands with s32 accumulators. No
// .satfinite: the sum wraps, as the reference's int32 accumulator does.
// Fragments: a[0] (row gr, k 4tq..4tq+3), a[1] (row gr+8, same k), a[2] and
// a[3] (the same rows, k 16+4tq..); b0 (k 4tq.., column gr), b1 (k 16+4tq..);
// c[0], c[1] (row gr, columns 2tq, 2tq+1), c[2], c[3] (row gr+8). Byte for
// byte that is the bf16 m16n8k16 layout, so ldmatrix (b16, not transposed)
// gives a's fragments from row-major rows of k as it does for bf16.
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16-byte chunk that holds chunk c of row r in a tile of b with CH
// chunks a row. A thread reads one 32-bit word from each of the rows 4q ..
// 4q+3 (q = lane % 4), the same word of each; rows 4 apart fall on the same
// banks where a row is a multiple of 128 bytes, so row r's chunks are XORed
// with 2((r / 4) % 4): the four q then read four distinct pairs of chunks.
template <int CH>
__host__ __device__ __forceinline__ int b_chunk(int r, int c) {
  static_assert(CH >= 4 && (CH & (CH - 1)) == 0, "chunks a row");
  return c ^ ((((r >> 2) & 3) << 1) & (CH - 1));
}

// rows x 16-byte chunks of a row-major int8 array with row stride lds, from
// (r0, c0), into dst with row stride ld (chunks placed by b_chunk where SWZ);
// rows from rows_total and columns from c_end on read as zero. vec: 16-byte
// cp.async, zero-filled past the edges (lds and c_end multiples of 16 and a
// 16-byte aligned base, so a chunk is wholly inside or outside); else byte
// by byte.
template <int ROWS, int COLS, int NT, bool SWZ>
__device__ __forceinline__ void stage8(uint8_t* dst, int ld, const int8_t* src, int lds, int r0, int rows_total,
                                       int c0, int c_end, bool vec) {
  constexpr int CH = COLS / 16;
#pragma unroll
  for (int it = 0; it < (ROWS * CH + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (i >= ROWS * CH) break;
    const int r = i / CH, ch = i % CH;
    const int gr = r0 + r, gc = c0 + ch * 16;
    int dch = ch;
    if constexpr (SWZ) dch = b_chunk<CH>(r, ch);
    uint8_t* d = dst + r * ld + dch * 16;
    if (vec) {
      const bool full = gr < rows_total && gc < c_end;
      cp_async16(d, full ? src + (size_t)gr * lds + gc : src, full);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        d[e] = (gr < rows_total && gc + e < c_end) ? (uint8_t)src[(size_t)gr * lds + gc + e] : (uint8_t)0;
      }
    }
  }
}

// Word w (bytes 4w .. 4w+3) of the rows r0 .. r0+3 of a b tile (BN bytes a
// row, swizzled), transposed: t[i] holds column 4w + i, byte j from row
// r0 + j, i.e. four consecutive k of one column, as a fragment wants them.
template <int BN>
__device__ __forceinline__ void load_cols4(const uint8_t* tile, int r0, int w, uint32_t (&t)[4]) {
  uint32_t x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + j;
    x[j] = *reinterpret_cast<const uint32_t*>(tile + r * BN + b_chunk<BN / 16>(r, w >> 2) * 16 + (w & 3) * 4);
  }
  // the 4x4 byte transpose
  const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t hi01 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t hi23 = __byte_perm(x[2], x[3], 0x7362);
  t[0] = __byte_perm(lo01, lo23, 0x5410);
  t[1] = __byte_perm(lo01, lo23, 0x7632);
  t[2] = __byte_perm(hi01, hi23, 0x5410);
  t[3] = __byte_perm(hi01, hi23, 0x7632);
}

// the epilogue of one accumulator: add half with int32 wrap-around (in
// unsigned: signed overflow is undefined), arithmetic shift right (round to
// nearest, ties up), then saturate only for an int8 output
template <typename TOut>
__device__ __forceinline__ TOut requantize(int s, int shift) {
  if (shift > 0) {
    const uint32_t u = (uint32_t)s + (1u << (shift - 1));
    s = (int)u >> shift;
  }
  if (sizeof(TOut) == 1) s = max(-128, min(127, s));
  return (TOut)s;
}

// out[idx .. idx+3] from four accumulators, the first `valid` of them in
// range; vec: idx is a multiple of 4 on a 16-byte aligned base, so all
// four go in one store
template <typename TOut>
__device__ __forceinline__ void store4(TOut* out, size_t idx, const int (&v)[4], int valid, bool vec, int shift) {
  if (vec && valid >= 4) {
    if constexpr (sizeof(TOut) == 4) {
      *reinterpret_cast<int4*>(out + idx) = make_int4(requantize<TOut>(v[0], shift), requantize<TOut>(v[1], shift),
                                                      requantize<TOut>(v[2], shift), requantize<TOut>(v[3], shift));
    } else {
      uint32_t w = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) w |= (uint32_t)(uint8_t)requantize<TOut>(v[e], shift) << (8 * e);
      *reinterpret_cast<uint32_t*>(out + idx) = w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < valid) out[idx + e] = requantize<TOut>(v[e], shift);
  }
}

constexpr int kI8SkM = 16;        // rows of a skinny_imma takes (M <= kI8SkM)
constexpr int kI8SkBN = 128;      // most columns of b a block takes (16 a unit)
constexpr int kI8SkBK = 64;       // k per stage of the ring
constexpr int kI8SkStages = 4;    // stages of the ring (kI8SkStages - 1 in flight)
constexpr int kI8SkThreads = kI8SkBN;      // a warp for each 32 columns
constexpr int kI8SkLdA = kI8SkBK + 16;     // padded rows: ldmatrix reads 8 rows without bank conflicts
constexpr size_t kI8SkSmem = (size_t)kI8SkStages * (kI8SkBK * kI8SkBN + kI8SkM * kI8SkLdA);
static_assert(kI8SkBN % 64 == 0 && kI8SkBK % 32 == 0, "skinny int8 tile");

// tiled_imma block tiles (rows x columns x k, warp tile, ring stages, blocks
// an SM): the large one where its tiles fill the card, the small one below
constexpr int kI8BM = 128, kI8BN = 128, kI8BK = 64, kI8WM = 64, kI8WN = 32, kI8Stages = 4, kI8MinBlocks = 2;
constexpr int kI8SBM = 64, kI8SBN = 64, kI8SBK = 64, kI8SWM = 32, kI8SWN = 32, kI8SStages = 4, kI8SMinBlocks = 4;

// out^T (16 columns of b x 8 rows of a) = b^T (16 x 32 k) . a^T (32 k x 8),
// one m16n8k32 per step. Warp w owns the 32 columns n0 + 32w .. of its
// block; its m16 tile t (0 or 1) takes, as row r, column 4r + 2t (r < 8)
// or 4(r - 8) + 2t + 1 (r >= 8): the four columns one transposed word
// holds feed rows gr and gr + 8 of two tiles, and the epilogue puts them
// back in order.
template <typename TOut>
__global__ void __launch_bounds__(kI8SkThreads)
matmul_imma_skinny(const int8_t* __restrict__ a, const int8_t* __restrict__ b, TOut* __restrict__ out, int M, int K,
                   int N, int shift, int a_vec, int b_vec, int out_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* Bs = smem_raw;                                // [kI8SkStages][kI8SkBK][kI8SkBN], swizzled
  uint8_t* As = Bs + kI8SkStages * kI8SkBK * kI8SkBN;     // [kI8SkStages][kI8SkM][kI8SkLdA]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  // an equal share of the 16-column units for each block, as skinny_mma
  const int units = (N + 15) / 16;
  const int n0 = (int)((long long)blockIdx.x * units / gridDim.x) * 16;
  const int n_end = min(N, (int)((long long)(blockIdx.x + 1) * units / gridDim.x) * 16);
  const int ktiles = (K + kI8SkBK - 1) / kI8SkBK;
  const bool two_m = M > 8;  // rows 8..15 exist: the second n8 tile of out^T

  auto load = [&](int kt) {
    const int slot = kt % kI8SkStages, k0 = kt * kI8SkBK;
    stage8<kI8SkBK, kI8SkBN, kI8SkThreads, true>(Bs + slot * kI8SkBK * kI8SkBN, kI8SkBN, b, N, k0, K, n0, n_end,
                                                 b_vec);
    stage8<kI8SkM, kI8SkBK, kI8SkThreads, false>(As + slot * kI8SkM * kI8SkLdA, kI8SkLdA, a, K, 0, M, k0, K, a_vec);
  };
#pragma unroll
  for (int s = 0; s < kI8SkStages - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }

  int acc[2][2][4];  // [m16 tile][8 rows of a][C fragment]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][u][e] = 0;
    }
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kI8SkStages - 2>();
    __syncthreads();  // tile kt has landed for everyone; tile kt - 1 is read
    if (kt + kI8SkStages - 1 < ktiles) load(kt + kI8SkStages - 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    const uint8_t* bs = Bs + (kt % kI8SkStages) * kI8SkBK * kI8SkBN;
    const uint8_t* as = As + (kt % kI8SkStages) * kI8SkM * kI8SkLdA;
#pragma unroll
    for (int kk = 0; kk < kI8SkBK; kk += 32) {
      // a^T as the B operand: rows 0-7 of a in bf[0..1], rows 8-15 in bf[2..3]
      uint32_t bf[4];
      ldmatrix_x4(bf, as + (lane % 8 + (lane / 16) * 8) * kI8SkLdA + kk + ((lane / 8) % 2) * 16);
      // b^T as the A operand: h picks the k half (a[0..1] or a[2..3]);
      // column 4gr + 2t + s is row gr + 8s of tile t
      uint32_t af[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t t[4];
        load_cols4<kI8SkBN>(bs, kk + 16 * h + 4 * tq, warp * 8 + gr, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) af[i / 2][2 * h + i % 2] = t[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_s8_16832(acc[i][0], af[i], bf[0], bf[1]);
        if (two_m) mma_s8_16832(acc[i][1], af[i], bf[2], bf[3]);
      }
    }
  }
  cp_async_wait<0>();

  // c[e] of tile t: row 8u + 2tq + (e & 1) of out, column 4gr + 2t + e / 2
  // of the warp's 32: c[e] and c[e + 2] of both tiles are four adjacent
  // columns
#pragma unroll
  for (int u = 0; u < 2; ++u) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = 8 * u + 2 * tq + e;
      const int col = n0 + warp * 32 + 4 * gr;
      if (m >= M || col >= n_end) continue;
      const int v[4] = {acc[0][u][e], acc[0][u][e + 2], acc[1][u][e], acc[1][u][e + 2]};
      store4<TOut>(out, (size_t)m * N + col, v, n_end - col, out_vec, shift);
    }
  }
}

// block tile BM x BN x BK, warps of WM x WN, a ring of STAGES, at least
// MINB blocks an SM. a's fragments by ldmatrix; b's by 32-bit loads and the
// byte transpose: word g of a warp's columns gives n8 tiles 4g .. 4g+3,
// tile 4g + i taking as column c the column 32g + 4c + i of the warp's WN.
template <typename TOut, int BM, int BN, int BK, int WM, int WN, int STAGES, int MINB>
__global__ void __launch_bounds__((BM / WM) * (BN / WN) * 32, MINB)
matmul_imma_tiled(const int8_t* __restrict__ a, const int8_t* __restrict__ b, TOut* __restrict__ out, int M, int K,
                  int N, int shift, int a_vec, int b_vec, int out_vec) {
  constexpr int NT = (BM / WM) * (BN / WN) * 32;
  constexpr int LDA = BK + 16;
  constexpr int MI = WM / 16, NG = WN / 32, NJ = 4 * NG;  // m16 tiles, words, n8 tiles of a warp
  static_assert(WM % 16 == 0 && WN % 32 == 0 && BK % 32 == 0 && BN % 64 == 0, "tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* As = smem_raw;                   // [STAGES][BM][LDA]
  uint8_t* Bs = As + STAGES * BM * LDA;     // [STAGES][BK][BN], swizzled
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int wm = warp / (BN / WN), wn = warp % (BN / WN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  auto load = [&](int kt) {
    const int slot = kt % STAGES, k0 = kt * BK;
    stage8<BM, BK, NT, false>(As + slot * BM * LDA, LDA, a, K, m0, M, k0, K, a_vec);
    stage8<BK, BN, NT, true>(Bs + slot * BK * BN, BN, b, N, k0, K, n0, N, b_vec);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s);
    cp_async_commit();
  }

  int acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    }
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < ktiles) load(kt + STAGES - 1);  // the slot of tile kt - 1
    cp_async_commit();
    const uint8_t* as = As + (kt % STAGES) * BM * LDA + (wm * WM) * LDA;
    const uint8_t* bs = Bs + (kt % STAGES) * BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MI][4], bfr[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldmatrix_x4(af[i], as + (i * 16 + lane % 16) * LDA + kk + (lane / 16) * 16);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t t[4];
          load_cols4<BN>(bs, kk + 16 * h + 4 * tq, (wn * WN) / 4 + 8 * g + gr, t);
#pragma unroll
          for (int i = 0; i < 4; ++i) bfr[4 * g + i][h] = t[i];
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_s8_16832(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // c[2h], c[2h+1] of tile 4g + i: row gr + 8h, columns 32g + 8tq + i and
  // 32g + 8tq + 4 + i of the warp's: a thread holds 8 adjacent columns
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * WM + i * 16 + gr + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = n0 + wn * WN + 32 * g + 8 * tq;
        if (col >= N) continue;
        const int v0[4] = {acc[i][4 * g][2 * h], acc[i][4 * g + 1][2 * h], acc[i][4 * g + 2][2 * h],
                           acc[i][4 * g + 3][2 * h]};
        const int v1[4] = {acc[i][4 * g][2 * h + 1], acc[i][4 * g + 1][2 * h + 1], acc[i][4 * g + 2][2 * h + 1],
                           acc[i][4 * g + 3][2 * h + 1]};
        store4<TOut>(out, (size_t)row * N + col, v0, N - col, out_vec, shift);
        if (col + 4 < N) store4<TOut>(out, (size_t)row * N + col + 4, v1, N - col - 4, out_vec, shift);
      }
    }
  }
}

template <int BM, int BN, int BK, int STAGES>
constexpr size_t imma_smem() {
  return (size_t)STAGES * (BM * (BK + 16) + BK * BN);
}

template <typename TOut, int BM, int BN, int BK, int WM, int WN, int STAGES, int MINB>
int launch_imma_tiled(const int8_t* a, const int8_t* b, TOut* out, int M, int K, int N, int shift, int a_vec,
                      int b_vec, int out_vec, cudaStream_t stream) {
  constexpr size_t smem = imma_smem<BM, BN, BK, STAGES>();
  static_assert(smem <= 232448, "tiled_imma ring exceeds shared memory");
  auto kernel = matmul_imma_tiled<TOut, BM, BN, BK, WM, WN, STAGES, MINB>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, (BM / WM) * (BN / WN) * 32, smem, stream>>>(a, b, out, M, K, N, shift, a_vec, b_vec, out_vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// route 3 (tiled_fma): float32 operands, M > 16, register-blocked CUDA cores
// ---------------------------------------------------------------------------

constexpr int kFBK = 8;
constexpr int kFThreads = 256;  // 16 x 16 threads, TM x TM outputs each

// rows of thread tm's tile: groups of four, 64 apart (16-byte shared loads)
__device__ __forceinline__ int frow(int tm, int i) { return (i / 4) * 64 + tm * 4 + i % 4; }

// block tile (16 TM) x (16 TM); TM = 8 (128 x 128) or 4 (64 x 64)
template <typename TOut, int TM>
__global__ void __launch_bounds__(kFThreads)
matmul_fma_tiled(const float* __restrict__ a, const float* __restrict__ b, TOut* __restrict__ out, int M, int K,
                 int N, int a_vec, int b_vec) {
  constexpr int BM = 16 * TM, LD = BM + 4;  // padded: the transposed stores of a hit 32 banks
  __shared__ __align__(16) float As[2][kFBK][LD];  // a transposed: [k][m]
  __shared__ __align__(16) float Bs[2][kFBK][LD];  // [k][n]
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BM;
  // this thread's share of a tile (threads below 2 BM): a row am, 4 k from
  // ka; b row kb, 4 columns from nb
  const bool loader = tid < 2 * BM;
  const int am = tid / 2, ka = (tid % 2) * 4;
  const int kb = tid / (BM / 4), nb = (tid % (BM / 4)) * 4;
  const int ktiles = (K + kFBK - 1) / kFBK;

  float ra[4], rb[4];
  auto fetch = [&](int kt) {
    if (!loader) return;
    const int k0 = kt * kFBK;
    const int gm = m0 + am, gk = k0 + ka;
    if (a_vec && gm < M && gk + 3 < K) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(a + (size_t)gm * K + gk));
      ra[0] = v.x; ra[1] = v.y; ra[2] = v.z; ra[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) ra[e] = (gm < M && gk + e < K) ? a[(size_t)gm * K + gk + e] : 0.f;
    }
    const int gkb = k0 + kb, gn = n0 + nb;
    if (b_vec && gkb < K && gn + 3 < N) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(b + (size_t)gkb * N + gn));
      rb[0] = v.x; rb[1] = v.y; rb[2] = v.z; rb[3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) rb[e] = (gkb < K && gn + e < N) ? b[(size_t)gkb * N + gn + e] : 0.f;
    }
  };
  auto put = [&](int slot) {
    if (!loader) return;
#pragma unroll
    for (int e = 0; e < 4; ++e) As[slot][ka + e][am] = ra[e];
    *reinterpret_cast<float4*>(&Bs[slot][kb][nb]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  float acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = 0.f;
  }
  fetch(0);
  put(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int slot = kt % 2;
    if (kt + 1 < ktiles) fetch(kt + 1);  // in flight while this tile is used
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float av[TM], bv[TM];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(&As[slot][k][g * 64 + tm * 4]);
        const float4 y = *reinterpret_cast<const float4*>(&Bs[slot][k][g * 64 + tn * 4]);
        av[4 * g] = x.x; av[4 * g + 1] = x.y; av[4 * g + 2] = x.z; av[4 * g + 3] = x.w;
        bv[4 * g] = y.x; bv[4 * g + 1] = y.y; bv[4 * g + 2] = y.z; bv[4 * g + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (kt + 1 < ktiles) put(slot ^ 1);  // that slot was read in step kt - 1
    __syncthreads();
  }

  const bool vec_out = (N % 4) == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + frow(tm, i);
    if (row >= M) continue;
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      const int col = n0 + h * 64 + tn * 4;
      TOut* o = out + (size_t)row * N + col;
      if constexpr (sizeof(TOut) == 4) {
        if (vec_out && col + 3 < N) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (col + e < N) o[e] = from_float<TOut>(acc[i][4 * h + e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

inline dim3 tile_grid(int M, int N) { return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM); }

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the current device's SM count (asked once per device)
inline int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return kSMs;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1) n = kSMs;
    counts[dev] = n;
  }
  return counts[dev];
}

// the large block tile where its tiles alone fill the card's SMs
inline bool large_tiles(int M, int N, int BM, int BN) {
  return (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN) >= sm_count();
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16
inline int route_of(int M, int in_dtype) {
  if (in_dtype == 0) return M <= kSkM ? 2 : 3;
  return M <= kSkM ? 0 : 1;
}

template <typename TIn, typename TOut>
int launch_matmul(const void* a, const void* b, void* out, int M, int K, int N, cudaStream_t stream) {
  const TIn* pa = static_cast<const TIn*>(a);
  const TIn* pb = static_cast<const TIn*>(b);
  TOut* po = static_cast<TOut*>(out);
  if constexpr (sizeof(TIn) == 4) {
    if (M <= kSkM) {
      const int vec_ok = (N % 4 == 0) && aligned16(b);
      matmul_fma_skinny<TIn, TOut><<<tile_grid(M, N), kThreads, 0, stream>>>(pa, pb, po, M, K, N, vec_ok);
    } else {
      const int a_vec = (K % 4 == 0) && aligned16(a), b_vec = (N % 4 == 0) && aligned16(b);
      if (large_tiles(M, N, 128, 128)) {
        const dim3 grid((N + 127) / 128, (M + 127) / 128);
        matmul_fma_tiled<TOut, 8><<<grid, kFThreads, 0, stream>>>(pa, pb, po, M, K, N, a_vec, b_vec);
      } else {
        const dim3 grid((N + 63) / 64, (M + 63) / 64);
        matmul_fma_tiled<TOut, 4><<<grid, kFThreads, 0, stream>>>(pa, pb, po, M, K, N, a_vec, b_vec);
      }
    }
  } else {
    const int a_vec = (K % 8 == 0) && aligned16(a), b_vec = (N % 8 == 0) && aligned16(b);
    if (M <= kSkM) {
      auto kernel = matmul_mma_skinny<TIn, TOut>;
      if (kSkSmem > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSkSmem);
        if (e != cudaSuccess) return (int)e;
      }
      // one block an SM, each with an equal share of the columns; more
      // blocks only where a share would exceed kSkBN columns
      const int units = (N + 15) / 16;
      int grid = sm_count();
      grid = max(grid, (units + kSkBN / 16 - 1) / (kSkBN / 16));
      grid = min(grid, units);
      kernel<<<grid, kSkThreads, kSkSmem, stream>>>(pa, pb, po, M, K, N, a_vec, b_vec);
    } else if (large_tiles(M, N, kTBM, kTBN)) {
      return launch_mma_tiled<TIn, TOut, kTBM, kTBN, kTBK, kTWM, kTWN, kTStages, kTMinBlocks>(pa, pb, po, M, K, N, a_vec,
                                                                                 b_vec, stream);
    } else {
      return launch_mma_tiled<TIn, TOut, kSBM, kSBN, kSBK, kSWM, kSWN, kSStages, kSMinBlocks>(pa, pb, po, M, K, N, a_vec,
                                                                                 b_vec, stream);
    }
  }
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_matmul_out(const void* a, const void* b, void* out, int M, int K, int N, int out_dtype,
                      cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return launch_matmul<TIn, float>(a, b, out, M, K, N, stream);
    case 1: return launch_matmul<TIn, __nv_bfloat16>(a, b, out, M, K, N, stream);
    case 2: return launch_matmul<TIn, __half>(a, b, out, M, K, N, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// matmul_int8's route for M rows: 0 skinny_imma (M <= 16), 1 tiled_imma
inline int route_int8(int M) { return M <= kI8SkM ? 0 : 1; }

template <typename TOut>
int launch_matmul_int8(const int8_t* a, const int8_t* b, TOut* out, int M, int K, int N, int shift,
                       cudaStream_t stream) {
  const int a_vec = (K % 16 == 0) && aligned16(a), b_vec = (N % 16 == 0) && aligned16(b);
  const int out_vec = (N % 4 == 0) && aligned16(out);
  if (route_int8(M) == 0) {
    auto kernel = matmul_imma_skinny<TOut>;
    if (kI8SkSmem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kI8SkSmem);
      if (e != cudaSuccess) return (int)e;
    }
    // one block an SM, each with an equal share of the columns; more
    // blocks only where a share would exceed kI8SkBN columns
    const int units = (N + 15) / 16;
    int grid = sm_count();
    grid = max(grid, (units + kI8SkBN / 16 - 1) / (kI8SkBN / 16));
    grid = min(grid, units);
    kernel<<<grid, kI8SkThreads, kI8SkSmem, stream>>>(a, b, out, M, K, N, shift, a_vec, b_vec, out_vec);
    return (int)cudaGetLastError();
  }
  if (large_tiles(M, N, kI8BM, kI8BN)) {
    return launch_imma_tiled<TOut, kI8BM, kI8BN, kI8BK, kI8WM, kI8WN, kI8Stages, kI8MinBlocks>(
        a, b, out, M, K, N, shift, a_vec, b_vec, out_vec, stream);
  }
  return launch_imma_tiled<TOut, kI8SBM, kI8SBN, kI8SBK, kI8SWM, kI8SWN, kI8SStages, kI8SMinBlocks>(
      a, b, out, M, K, N, shift, a_vec, b_vec, out_vec, stream);
}

}  // namespace

// a (M,K), b (K,N), out (M,N), all row-major and contiguous; a and b share
// in_dtype (codes as route_of). M <= repro_matmul_max_rows(in_dtype).
extern "C" int repro_matmul(const void* a, const void* b, void* out, int M, int K, int N, int in_dtype,
                            int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  switch (in_dtype) {
    case 0: return launch_matmul_out<float>(a, b, out, M, K, N, out_dtype, s);
    case 1: return launch_matmul_out<__nv_bfloat16>(a, b, out, M, K, N, out_dtype, s);
    case 2: return launch_matmul_out<__half>(a, b, out, M, K, N, out_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The route repro_matmul takes for M rows of in_dtype operands: 0
// skinny_mma, 1 tiled_mma, 2 skinny_fma, 3 tiled_fma; -1 for a bad code.
// K and N do not enter the choice today; they are part of the question.
extern "C" int repro_matmul_route(int M, int K, int N, int in_dtype) {
  (void)K;
  (void)N;
  if (M < 1 || in_dtype < 0 || in_dtype > 2) return -1;
  return route_of(M, in_dtype);
}

// The route repro_matmul_int8 takes for an (M,K) @ (K,N) product: 0
// skinny_imma, 1 tiled_imma; -1 for no rows. K and N do not enter the
// choice today; they are part of the question.
extern "C" int repro_matmul_int8_route(int M, int K, int N) {
  (void)K;
  (void)N;
  if (M < 1) return -1;
  return route_int8(M);
}

// The most rows of a that one launch takes, from the grid that really
// launches: in_dtype 0-2 for repro_matmul, 3 for repro_matmul_int8. The
// tiled routes put row tiles on grid.y: 128 rows each (tiled_fma's and
// tiled_mma's, tiled_imma's kI8BM); the skinny routes take M <= 16, and
// the 64-row tiles run only shapes with fewer tiles than the card has SMs.
extern "C" int repro_matmul_max_rows(int in_dtype) {
  if (in_dtype == 3) return kGridY * kI8BM;
  if (in_dtype < 0 || in_dtype > 2) return -1;
  constexpr int rows = kTBM < 128 ? kTBM : 128;  // tiled_fma's large tile has 128
  return kGridY * rows;
}

// int8 a (M,K) @ int8 b (K,N) -> out (M,N), int32 (out_int8 == 0) or int8.
// shift in [0, 31]; 0 means no requantization.
extern "C" int repro_matmul_int8(const void* a, const void* b, void* out, int M, int K, int N, int shift,
                                 int out_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || N < 1 || shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  if (out_int8) return launch_matmul_int8<int8_t>(pa, pb, static_cast<int8_t*>(out), M, K, N, shift, s);
  return launch_matmul_int8<int32_t>(pa, pb, static_cast<int32_t*>(out), M, K, N, shift, s);
}
