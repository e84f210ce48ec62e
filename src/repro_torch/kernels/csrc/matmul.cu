// Matrix products for the logits head: matmul (f32 / bf16 / f16 operands,
// fp32 accumulation) and matmul_int8 (int8 operands, exact int32
// accumulation, optional requantization).
//
// Replaces: repro/kernels/matmul.py::_matmul_kernel (wrapper `matmul`) and
// ::_matmul_int8_kernel (wrapper `matmul_int8`). There the K axis is the
// innermost, sequential grid axis and the accumulator lives in scratch
// memory across grid steps, zeroed on the first step and written out on the
// last. Here blocks run in no order, so the K loop sits inside the block:
// the code before the loop is the first-step init, the code after it the
// last-step epilogue, and the accumulator is in registers.
//
// What bounds it on an H100 at the serving shape, a(slots, 2048) @
// b(2048, 32000) with slots <= 16: every element of b is used only `slots`
// times, far below the card's ridge of a few hundred operations per byte, so
// the bound is the time to read b once from device memory — 131 MB in bf16,
// 65.5 MB in int8, 262 MB in f32 — and not arithmetic.
//
// What the design does about it:
//  - A tile of few rows and many columns: 8 rows of a by 128 columns of b
//    per block, one block per output tile, 250 blocks over N = 32000. An M
//    larger than 8 adds grid rows and reads b again (served by L2 where it
//    fits): right, and fast only for the skinny shape this path has.
//  - b never passes through shared memory. Each thread reads 16 bytes of one
//    row of b (4 f32, 8 bf16/f16 or 16 int8 columns) straight into
//    registers, neighbouring threads on neighbouring addresses, and keeps an
//    8 x (its columns) accumulator in registers. The loads of 8 rows (matmul)
//    or 2 x 4 rows (matmul_int8) are issued before the first is used: with
//    one load in flight per thread the kernels ran at about half the rate.
//    The few rows of a are staged in shared memory per K chunk, already
//    converted, and read as broadcasts.
//  - The 256 threads of a block cover the 128 columns several times over;
//    each replica takes every KS-th row of b (a K slice). After the loop the
//    slices are summed: by shuffles inside a warp, then through shared
//    memory across warps, in a fixed order, so results are deterministic.
//  - int8 uses __dp4a: four rows of b are loaded, each 4x4 byte block is
//    transposed in registers (__byte_perm) so that one 32-bit word holds one
//    column's four consecutive k, and multiplied with a word of a that holds
//    the same four k of one row.
//  - Ragged edges are masked in the kernel: rows past M and k past K read as
//    zero, columns past N are neither read nor written; where N or the base
//    address does not allow 16-byte loads the kernel reads b element by
//    element.
// Tensor-core instructions (mma.sync / wgmma), cp.async / TMA and a weight
// layout made for them are what a faster version would add.
//
// C interface (loaded with ctypes): each function launches on the given
// stream, does not synchronise, allocates nothing and returns the launch's
// cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 8;    // rows of a (and of out) per block
constexpr int kBN = 128;  // columns of b (and of out) per block
constexpr int kU = 8;     // matmul: rows of b loaded ahead per thread
constexpr int kUI = 2;    // matmul_int8: groups of four rows loaded ahead per thread

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
// matmul: f32 / bf16 / f16 operands, fp32 accumulation, one cast at the end
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
matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b, TOut* __restrict__ out,
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
// matmul_int8: int8 operands, exact int32 accumulation, requantize at the end
// ---------------------------------------------------------------------------

// acc[m][c] += sum_j a[m][k+j] * b[k+j][c] for four consecutive k and 16
// columns. x[j][w] is row k+j of b, columns 4w .. 4w+3 (byte 0 the lowest
// column); a_w points at the word of As that holds a[0][k .. k+3].
__device__ __forceinline__ void dp4a_group(int (&acc)[kBM][16], const int* a_w, int stride,
                                           const uint32_t (&x)[4][4]) {
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    // transpose the 4x4 byte block: t[i] = column 4w+i, byte j = row k+j
    const uint32_t lo01 = __byte_perm(x[0][w], x[1][w], 0x5140);
    const uint32_t hi01 = __byte_perm(x[0][w], x[1][w], 0x7362);
    const uint32_t lo23 = __byte_perm(x[2][w], x[3][w], 0x5140);
    const uint32_t hi23 = __byte_perm(x[2][w], x[3][w], 0x7362);
    uint32_t t[4];
    t[0] = __byte_perm(lo01, lo23, 0x5410);
    t[1] = __byte_perm(lo01, lo23, 0x7632);
    t[2] = __byte_perm(hi01, hi23, 0x5410);
    t[3] = __byte_perm(hi01, hi23, 0x7632);
#pragma unroll
    for (int m = 0; m < kBM; ++m) {
      const int aw = a_w[m * stride];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][4 * w + i] = __dp4a(aw, (int)t[i], acc[m][4 * w + i]);
    }
  }
}

template <typename TOut>  // int32_t or int8_t
__global__ void __launch_bounds__(kThreads)
matmul_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b, TOut* __restrict__ out,
                   int M, int K, int N, int shift, int vec_ok, int a_words_ok) {
  constexpr int VEC = 16;
  constexpr int TN = kBN / VEC;      // 8 threads along N
  constexpr int KS = kThreads / TN;  // 32 K slices, each step takes 4 consecutive k
  constexpr int BKC = 2048;          // k per staged chunk of a
  constexpr int BKW = BKC / 4;       // ... in 32-bit words of four k
  static_assert(kBM * BKW <= kWarps * kBM * kBN, "a chunk must fit the reduction buffer");
  __shared__ __align__(16) int smem[kWarps * kBM * kBN];  // a chunk [kBM][BKW], later the slices
  int* As = smem;

  const int tid = threadIdx.x;
  const int tn = tid % TN, ks = tid / TN;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN + tn * VEC;

  int acc[kBM][VEC];
#pragma unroll
  for (int m = 0; m < kBM; ++m) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[m][c] = 0;
  }

  for (int kc = 0; kc < K; kc += BKC) {
    const int klen = min(BKC, K - kc);
    __syncthreads();
    // a word of As holds a[row][k .. k+3], byte 0 the lowest k; k past K are zero
    for (int i = tid; i < kBM * BKW; i += kThreads) {
      const int m = i / BKW, w = i % BKW;
      uint32_t word = 0;
      if (row0 + m < M && 4 * w < klen) {
        const int8_t* p = a + (size_t)(row0 + m) * K + kc + 4 * w;
        if (a_words_ok && 4 * w + 4 <= klen) {
          word = *reinterpret_cast<const uint32_t*>(p);
        } else {
          for (int j = 0; j < 4; ++j) {
            if (4 * w + j < klen) word |= (uint32_t)(uint8_t)p[j] << (8 * j);
          }
        }
      }
      As[m * BKW + w] = (int)word;
    }
    __syncthreads();
    if (col0 < N) {
      int kw = ks;  // index of a group of four k (one word of As) in this chunk
      if (vec_ok) {
        // kUI whole groups at a time: 4 * kUI 16-byte loads in flight per thread
        for (; 4 * (kw + (kUI - 1) * KS) + 4 <= klen; kw += kUI * KS) {
          uint4 raw[kUI][4];
#pragma unroll
          for (int u = 0; u < kUI; ++u) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              raw[u][j] = __ldg(reinterpret_cast<const uint4*>(
                  b + (size_t)(kc + 4 * (kw + u * KS) + j) * N + col0));
            }
          }
#pragma unroll
          for (int u = 0; u < kUI; ++u) {
            uint32_t x[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              x[j][0] = raw[u][j].x; x[j][1] = raw[u][j].y; x[j][2] = raw[u][j].z; x[j][3] = raw[u][j].w;
            }
            dp4a_group(acc, As + kw + u * KS, BKW, x);
          }
        }
      }
      // the rest of the chunk, rows past K read as zero — all of the chunk
      // where 16-byte loads do not fit
      for (; 4 * kw < klen; kw += KS) {
        uint32_t x[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = 4 * kw + j;
          x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0u;
          if (kk < klen) {
            const int8_t* brow = b + (size_t)(kc + kk) * N;
            if (vec_ok) {
              const uint4 raw = __ldg(reinterpret_cast<const uint4*>(brow + col0));
              x[j][0] = raw.x; x[j][1] = raw.y; x[j][2] = raw.z; x[j][3] = raw.w;
            } else {
#pragma unroll
              for (int w = 0; w < 4; ++w) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int c = col0 + 4 * w + i;
                  if (c < N) x[j][w] |= (uint32_t)(uint8_t)brow[c] << (8 * i);
                }
              }
            }
          }
        }
        dp4a_group(acc, As + kw, BKW, x);
      }
    }
  }
  __syncthreads();

  const int colb = blockIdx.x * kBN;
  reduce_slices<int, VEC>(acc, smem, [&](int m, int c, int s) {
    if (row0 + m < M && colb + c < N) {
      if (shift > 0) {
        // add half with int32 wrap-around (in unsigned: signed overflow is
        // undefined), then arithmetic shift right: round to nearest, ties up
        const uint32_t u = (uint32_t)s + (1u << (shift - 1));
        s = (int)u >> shift;
      }
      if (sizeof(TOut) == 1) s = max(-128, min(127, s));  // saturate, not wrap
      out[(size_t)(row0 + m) * N + colb + c] = (TOut)s;
    }
  });
}

inline dim3 tile_grid(int M, int N) { return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM); }

template <typename TIn, typename TOut>
int launch_matmul(const void* a, const void* b, void* out, int M, int K, int N, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(TIn);
  const int vec_ok = (N % VEC == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  matmul_kernel<TIn, TOut><<<tile_grid(M, N), kThreads, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b), static_cast<TOut*>(out), M, K, N, vec_ok);
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

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16. a (M,K), b (K,N), out (M,N),
// all row-major and contiguous; a and b share in_dtype.
extern "C" int repro_matmul(const void* a, const void* b, void* out, int M, int K, int N, int in_dtype,
                            int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case 0: return launch_matmul_out<float>(a, b, out, M, K, N, out_dtype, s);
    case 1: return launch_matmul_out<__nv_bfloat16>(a, b, out, M, K, N, out_dtype, s);
    case 2: return launch_matmul_out<__half>(a, b, out, M, K, N, out_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}

// int8 a (M,K) @ int8 b (K,N) -> out (M,N), int32 (out_int8 == 0) or int8.
// shift in [0, 31]; 0 means no requantization.
extern "C" int repro_matmul_int8(const void* a, const void* b, void* out, int M, int K, int N, int shift,
                                 int out_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
  const int vec_ok = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  const int a_words_ok = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 4 == 0);
  const int8_t* pa = static_cast<const int8_t*>(a);
  const int8_t* pb = static_cast<const int8_t*>(b);
  if (out_int8) {
    matmul_int8_kernel<int8_t><<<tile_grid(M, N), kThreads, 0, s>>>(
        pa, pb, static_cast<int8_t*>(out), M, K, N, shift, vec_ok, a_words_ok);
  } else {
    matmul_int8_kernel<int32_t><<<tile_grid(M, N), kThreads, 0, s>>>(
        pa, pb, static_cast<int32_t*>(out), M, K, N, shift, vec_ok, a_words_ok);
  }
  return (int)cudaGetLastError();
}
