// Blockwise (flash) attention for Hopper: the forward with its block-skip
// probe, and the two recompute-p backward kernels (dQ; dK and dV).
//
// Replaces: repro/kernels/attention.py::_fwd_kernel (wrappers
// `flash_attention`, `flash_attention_probe`), ::_bwd_dq_kernel and
// ::_bwd_dkv_kernel. There the innermost grid axis (kb in the forward and
// dQ, qb in dK/dV) runs in order and carries the running max, the
// denominator and the accumulators in scratch memory from one grid step to
// the next. Here blocks run in no order, so that axis is a loop inside the
// thread block: one block per (g, q-block) for the forward and dQ, one per
// (g, kv-block) for dK/dV, with the accumulators in registers and the
// running statistics in shared memory. The code before the loop is the
// reference's first-step init, the code after it the last-step finalize.
//
// Semantics kept from the reference:
//  - mask = kv_mask & (q_pos >= k_pos) on raw indices when causal;
//  - the causal block skip is the loop bound: the forward and dQ walk the
//    keys of KV blocks 0 .. min(n_k-1, (qb*bq+bq-1)/bk) only, dK/dV walk
//    the queries from the first q block the triangle reaches,
//    ((kb*bk)/bq)*bq; the forward stores that trip count (in KV blocks of
//    bk keys) as the probe, so probe[g, qb] == min(n_k, (qb*bq+bq-1)/bk + 1),
//    qb + 1 on square blocks;
//  - dead rows: m_safe = m > NEG_INF/2 ? m : 0 (and lse_safe alike), so
//    masked scores underflow to exactly 0; out = acc/l, zero where l == 0;
//    lse = m + log l, NEG_INF for dead rows;
//  - p is rounded to v's type before P.V, ds to k's (q's) type before
//    dS.K (dS^T.Q), p to dO's type before P^T.dO, exactly where the
//    reference calls astype;
//  - float32, bfloat16 and float16 operands accumulate in float32: float32
//    with true fp32 FMAs (no TF32), bfloat16 and float16 in the tensor
//    cores' fp32 accumulators (exact products of the narrow operands);
//    float64 operands accumulate in float64 and lse, delta are float64 then
//    (float32 otherwise).
//
// What bounds it on an H100 at the training shape (B 4, H 32, S 2048,
// D 64, bf16, causal): operations, not memory. The products of the causal
// triangle (S(S+1)/2 pairs per head, 2*D operations a pair per product)
// over the bf16 tensor-core rate of 989 TFLOP/s: the forward's two products
// 6.9e10 FLOP (0.070 ms) over 134 MB of q, k, v and out, about 516
// operations per byte, far above the card's ridge of ~295; dQ's three
// products (q.k, dO.v, ds.k) 1.03e11 FLOP (0.104 ms); dK/dV's four (q.k,
// dO.v, p.dO, ds.q) 1.37e11 FLOP (0.139 ms).
//
// What the design does about it:
//  - Nothing O(S^2) reaches device memory: each score tile lives in
//    registers or shared memory only, the backward recomputes p from q, k
//    and the saved lse.
//  - bfloat16 and float16 operands (flash_fwd_mma, flash_bwd_dq_mma,
//    flash_bwd_dkv_mma): every tile product runs on the tensor cores as
//    mma.sync m16n8k16 with fp32 accumulators (mma_sm90.cuh). A block of
//    four warps owns 64 rows, 16 per warp: query rows in the forward and
//    dQ, which hold their Q (and dO) tiles and stream K, V in tiles of 64
//    keys; key rows in dK/dV, which holds its K and V tiles and streams Q,
//    dO with their lse and delta in tiles of 64 queries (32 at head widths
//    above 64). The streamed tiles are double-buffered with 16-byte
//    cp.async copies, so the next tile is in flight while this one
//    computes. Tiles stay in their own type in shared memory, rows padded
//    by 16 bytes so that ldmatrix is free of bank conflicts. Scores are C
//    fragments in registers, masked by select (masked, padded and dead
//    entries exactly 0 after the exp) and turned into p (and ds) there;
//    rounded to the operands' type and packed in pairs they are the A
//    fragments of the next product, which is the reference's astype. dK/dV
//    forms the scores transposed (keys by queries), so P^T and dS^T feed
//    dV += P^T dO and dK += dS^T Q as they stand.
//  - Forward: the online softmax stays in registers. Each warp forms the
//    scores of its 16 rows against the whole 64-key tile (the plain
//    version's chunk, so p is rounded against the same running max), takes
//    the row max over the four lanes of a row with two shuffles, rescales
//    its accumulator by alpha and adds P V. Scores are kept in log2 units
//    (scale * log2 e folded into one multiply) so that every exp is one
//    ex2.approx; each lane sums l over its own columns, the four sums are
//    added once at the end. Q's A fragments are held in registers across
//    the key loop at up to 64 head columns (16 registers) and re-read by
//    ldmatrix per k16 step at 128. The scores of a whole tile take more
//    registers than the backward's passes: the forward is bounded to 168
//    a thread (three blocks an SM), without spilling. A warp whose rows all
//    lie before a tile's first key (causal) skips the tile: that leaves its
//    statistics as a fully masked tile would.
//  - Backward: scores are formed in passes of 32 keys (dQ) or 16 queries
//    (dK/dV), so that a thread keeps within 128 registers at 64 head
//    columns without spilling.
//  - Four blocks (16 warps) of the backward, three of the forward, share
//    an SM at 64 head columns and hide each other's latencies; that, the
//    heads-fastest block order (heavy causal blocks of every head first),
//    the tile and pass sizes, the held Q fragments and ex2.approx for exp
//    were chosen by timing (tools/torch_attention_variants.py).
//    Each output row has one writer: no atomics, deterministic.
//  - float32 and float64 operands (flash_fwd_kernel, flash_bwd_dq_kernel,
//    flash_bwd_dkv_kernel): on the CUDA cores in true fp32 (fp64) FMAs, no
//    TF32. Operand tiles are staged in shared memory in the accumulator
//    type, rows padded by one element so that the transposed reads (K^T,
//    Q^T) hit distinct banks; every tile product is a 16 x 16 thread grid
//    in which each thread owns a 4 x 4 (2 x 2) micro-tile of the scores
//    and a 4 x (D/16) micro-tile of the accumulator. Its ceiling is the
//    fp32 rate (67 TFLOP/s), ~15x the card's bound. The row statistics of
//    the online softmax are reduced by the 4 (8) threads of a row with warp
//    shuffles.
//  - Heavy causal blocks are scheduled first (the forward and dQ take
//    q-blocks from the last; dK/dV's heavy blocks are the first kv-blocks).
//  - The wrapper's bq, bk set the block-skip bounds above; each kernel's own
//    tile is its own choice and splits a wrapper block into parts.
// What a faster version adds: wgmma (four warps on a 64-row tile, B from
// shared memory), TMA copies with mbarriers, warp specialisation (a
// producer warp keeping the ring of tiles full).
//
// C interface (loaded with ctypes): each function launches on the given
// stream, does not synchronise, allocates nothing and returns the launch's
// cudaError_t (0 on success). Operands are contiguous, flattened and padded
// by the caller: q (G,Sq,D), k and v (G,Sk,D), kvm (G,Sk) int32, with
// Sq % bq == 0 and Sk % bk == 0; all float operands share one dtype code:
// 0 float32, 1 bfloat16, 2 float16, 3 float64.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;     // a 16 x 16 thread grid over every tile product
constexpr double kNegInf = -1e30;
constexpr double kDeadRow = -0.5e30;

// rows (and keys) per staged tile, by accumulator type
template <typename A> struct Tile;
template <> struct Tile<float> { static constexpr int value = 64; };
template <> struct Tile<double> { static constexpr int value = 32; };

template <typename A, typename T> __device__ __forceinline__ A widen(T v);
template <> __device__ __forceinline__ float widen<float, float>(float v) { return v; }
template <> __device__ __forceinline__ float widen<float, __nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float widen<float, __half>(__half v) { return __half2float(v); }
template <> __device__ __forceinline__ double widen<double, double>(double v) { return v; }

template <typename T, typename A> __device__ __forceinline__ T narrow(A v);
template <> __device__ __forceinline__ float narrow<float, float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half narrow<__half, float>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ double narrow<double, double>(double v) { return v; }

// v rounded to T and back: the reference's astype before a product
template <typename T, typename A> __device__ __forceinline__ A round_to(A v) {
  return widen<A, T>(narrow<T, A>(v));
}

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) { return fmax(a, b); }

// c[i][j] += sum_{k < K} a(ty + 16 i, k) * b(k, tx + 16 j) for this thread's
// micro-tile, where a(m, k) = a[m * a_m + k * a_k], b(k, n) = b[k * b_k + n * b_n]
template <int TM, int TN, typename A>
__device__ __forceinline__ void tile_mma(A (&c)[TM][TN], const A* a, int a_m, int a_k,
                                         const A* b, int b_k, int b_n, int K) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    A av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = a[(ty + 16 * i) * a_m + k * a_k];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = b[k * b_k + (tx + 16 * j) * b_n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = fma_(av[i], bv[j], c[i][j]);
    }
  }
}

template <int TM, int TN, typename A>
__device__ __forceinline__ void zero(A (&c)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) c[i][j] = A(0);
  }
}

// dst[r * ld + d] = src[r * D + d] widened, for r < TL and d < DP; zero where
// r >= rows or d >= D (the padded head columns contribute nothing)
template <int TL, int DP, typename A, typename T>
__device__ __forceinline__ void load_tile(A* dst, int ld, const T* __restrict__ src, int rows, int D) {
  for (int i = threadIdx.x; i < TL * DP; i += kThreads) {
    const int r = i / DP, d = i % DP;
    A v = A(0);
    if (r < rows && d < D) v = widen<A, T>(src[(size_t)r * D + d]);
    dst[r * ld + d] = v;
  }
}

template <typename A>
__device__ __forceinline__ A safe_lse(A l) { return l > A(kDeadRow) ? l : A(0); }

struct Params {
  const void *q, *k, *v, *dout;
  const int* kvm;
  const void *lse_in, *delta;
  void *out, *lse, *dq, *dk, *dv;
  int* probe;
  int G, Sq, Sk, D, bq, bk, causal;
};

// ---------------------------------------------------------------------------
// float32 / float64 forward: one block per (g, q-block); KV loop up to the
// causal bound
// ---------------------------------------------------------------------------

template <typename T, typename A, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kvm, T* __restrict__ out, A* __restrict__ lse,
                 int* __restrict__ probe, int Sq, int Sk, int D, int bq, int bk, int causal) {
  constexpr int TL = Tile<A>::value;
  constexpr int TM = TL / 16;          // score rows (and columns) per thread
  constexpr int TN = DP / 16;          // head columns per thread
  constexpr int LD = DP + 1;           // padded row of a (TL x DP) tile
  constexpr int LS = TL + 1;           // padded row of a (TL x TL) tile
  constexpr int TPR = kThreads / TL;   // threads per row in the softmax step
  constexpr int CPT = TL / TPR;        // ... and the columns each one takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* Qs = reinterpret_cast<A*>(smem_raw);
  A* Ks = Qs + TL * LD;
  A* Vs = Ks + TL * LD;
  A* Ss = Vs + TL * LD;
  A* m_s = Ss + TL * LS;
  A* l_s = m_s + TL;
  A* a_s = l_s + TL;
  int* valid_s = reinterpret_cast<int*>(a_s + TL);

  const int g = blockIdx.x;
  const int n_q = gridDim.y;
  const int qb = n_q - 1 - (int)blockIdx.y;  // heaviest causal blocks first
  const int n_k = Sk / bk;
  const int kb_last = causal ? min(n_k - 1, (qb * bq + bq - 1) / bk) : n_k - 1;
  const int k_end = (kb_last + 1) * bk;    // the block skip: keys past it are never read
  if (threadIdx.x == 0) probe[(size_t)g * n_q + qb] = kb_last + 1;

  const A scale = A(1.0 / sqrt((double)D));
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qg = q + (size_t)g * Sq * D;
  const T* kg = k + (size_t)g * Sk * D;
  const T* vg = v + (size_t)g * Sk * D;
  const int* mg = kvm + (size_t)g * Sk;
  T* og = out + (size_t)g * Sq * D;
  A* lg = lse + (size_t)g * Sq;

  for (int r0 = qb * bq; r0 < qb * bq + bq; r0 += TL) {
    const int rows = min(TL, qb * bq + bq - r0);
    __syncthreads();  // the previous row tile has been read
    load_tile<TL, DP>(Qs, LD, qg + (size_t)r0 * D, rows, D);
    for (int i = threadIdx.x; i < TL; i += kThreads) {
      m_s[i] = A(kNegInf);
      l_s[i] = A(0);
    }
    A acc[TM][TN];
    zero(acc);

    for (int c0 = 0; c0 < k_end; c0 += TL) {
      const int cols = min(TL, k_end - c0);
      __syncthreads();  // K, V and S of the previous chunk have been read
      load_tile<TL, DP>(Ks, LD, kg + (size_t)c0 * D, cols, D);
      load_tile<TL, DP>(Vs, LD, vg + (size_t)c0 * D, cols, D);
      for (int i = threadIdx.x; i < TL; i += kThreads) valid_s[i] = i < cols ? mg[c0 + i] : 0;
      __syncthreads();

      A s[TM][TM];
      zero(s);
      tile_mma<TM, TM>(s, Qs, LD, 1, Ks, 1, LD, DP);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const bool keep = valid_s[c] != 0 && (!causal || r0 + r >= c0 + c);
          Ss[r * LS + c] = keep ? s[i][j] * scale : A(kNegInf);
        }
      }
      __syncthreads();

      {  // online softmax over this chunk, TPR threads per row
        const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
        A* srow = Ss + r * LS + part * CPT;
        A mx = A(kNegInf);
#pragma unroll
        for (int c = 0; c < CPT; ++c) mx = max_(mx, srow[c]);
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) mx = max_(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const A m_prev = m_s[r];
        const A m_new = max_(m_prev, mx);
        // dead rows keep m_new == NEG_INF: exp against 0 underflows their
        // masked scores to 0 instead of exp(0) == 1
        const A m_safe = m_new > A(kDeadRow) ? m_new : A(0);
        const A alpha = exp_(m_prev - m_new);
        A psum = A(0);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const A p = exp_(srow[c] - m_safe);
          psum += p;
          srow[c] = round_to<T, A>(p);  // p.astype(v.dtype)
        }
#pragma unroll
        for (int off = TPR / 2; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
        __syncwarp();  // every lane of the row has read m_s[r]
        if (part == 0) {
          m_s[r] = m_new;
          l_s[r] = l_s[r] * alpha + psum;
          a_s[r] = alpha;
        }
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const A al = a_s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] *= al;
      }
      tile_mma<TM, TN>(acc, Ss, LS, 1, Vs, LD, 1, cols);
    }
    __syncthreads();  // the final l_s / m_s are visible

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows) continue;
      const A l = l_s[r];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int d = tx + 16 * j;
        if (d < D) og[(size_t)(r0 + r) * D + d] = narrow<T, A>(l > A(0) ? acc[i][j] / l : A(0));
      }
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const A l = l_s[r];
      lg[r0 + r] = l > A(0) ? m_s[r] + log_(l) : A(kNegInf);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (g, q-block); same KV loop bound as the forward
// ---------------------------------------------------------------------------

template <typename T, typename A, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ kvm, const T* __restrict__ dout, const A* __restrict__ lse,
                    const A* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int D, int bq,
                    int bk, int causal) {
  constexpr int TL = Tile<A>::value;
  constexpr int TM = TL / 16;
  constexpr int TN = DP / 16;
  constexpr int LD = DP + 1;
  constexpr int LS = TL + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* Qs = reinterpret_cast<A*>(smem_raw);
  A* dOs = Qs + TL * LD;
  A* Ks = dOs + TL * LD;
  A* Vs = Ks + TL * LD;
  A* Ss = Vs + TL * LD;
  A* lse_s = Ss + TL * LS;
  A* delta_s = lse_s + TL;
  int* valid_s = reinterpret_cast<int*>(delta_s + TL);

  const int g = blockIdx.x;
  const int n_q = gridDim.y;
  const int qb = n_q - 1 - (int)blockIdx.y;
  const int n_k = Sk / bk;
  const int kb_last = causal ? min(n_k - 1, (qb * bq + bq - 1) / bk) : n_k - 1;
  const int k_end = (kb_last + 1) * bk;

  const A scale = A(1.0 / sqrt((double)D));
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)g * Sq * D, koff = (size_t)g * Sk * D;
  const int* mg = kvm + (size_t)g * Sk;

  for (int r0 = qb * bq; r0 < qb * bq + bq; r0 += TL) {
    const int rows = min(TL, qb * bq + bq - r0);
    __syncthreads();
    load_tile<TL, DP>(Qs, LD, q + qoff + (size_t)r0 * D, rows, D);
    load_tile<TL, DP>(dOs, LD, dout + qoff + (size_t)r0 * D, rows, D);
    for (int i = threadIdx.x; i < TL; i += kThreads) {
      const size_t at = (size_t)g * Sq + r0 + i;
      lse_s[i] = i < rows ? safe_lse(lse[at]) : A(0);
      delta_s[i] = i < rows ? delta[at] : A(0);
    }
    A acc[TM][TN];
    zero(acc);

    for (int c0 = 0; c0 < k_end; c0 += TL) {
      const int cols = min(TL, k_end - c0);
      __syncthreads();
      load_tile<TL, DP>(Ks, LD, k + koff + (size_t)c0 * D, cols, D);
      load_tile<TL, DP>(Vs, LD, v + koff + (size_t)c0 * D, cols, D);
      for (int i = threadIdx.x; i < TL; i += kThreads) valid_s[i] = i < cols ? mg[c0 + i] : 0;
      __syncthreads();

      A s[TM][TM], dp[TM][TM];
      zero(s);
      zero(dp);
      tile_mma<TM, TM>(s, Qs, LD, 1, Ks, 1, LD, DP);    // q k^T
      tile_mma<TM, TM>(dp, dOs, LD, 1, Vs, 1, LD, DP);  // dO v^T
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const bool keep = valid_s[c] != 0 && (!causal || r0 + r >= c0 + c);
          const A p = keep ? exp_(s[i][j] * scale - lse_s[r]) : A(0);
          const A ds = p * (dp[i][j] - delta_s[r]) * scale;
          Ss[r * LS + c] = round_to<T, A>(ds);  // ds.astype(k.dtype)
        }
      }
      __syncthreads();
      tile_mma<TM, TN>(acc, Ss, LS, 1, Ks, LD, 1, cols);  // dQ += dS k
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int d = tx + 16 * j;
        if (d < D) dq[qoff + (size_t)(r0 + r) * D + d] = narrow<T, A>(acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV: one block per (g, kv-block); q loop from the first q block the
// causal triangle reaches
// ---------------------------------------------------------------------------

template <typename T, typename A, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ kvm, const T* __restrict__ dout, const A* __restrict__ lse,
                     const A* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                     int D, int bq, int bk, int causal) {
  constexpr int TL = Tile<A>::value;
  constexpr int TM = TL / 16;
  constexpr int TN = DP / 16;
  constexpr int LD = DP + 1;
  constexpr int LS = TL + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  A* Ks = reinterpret_cast<A*>(smem_raw);
  A* Vs = Ks + TL * LD;
  A* Qs = Vs + TL * LD;
  A* dOs = Qs + TL * LD;
  A* Ps = dOs + TL * LD;   // [kv row][q row]
  A* dSs = Ps + TL * LS;
  A* lse_s = dSs + TL * LS;
  A* delta_s = lse_s + TL;
  int* valid_s = reinterpret_cast<int*>(delta_s + TL);

  const int g = blockIdx.x;
  const int kb = blockIdx.y;
  const int q_lo = causal ? ((kb * bk) / bq) * bq : 0;  // the block skip, from below

  const A scale = A(1.0 / sqrt((double)D));
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = (size_t)g * Sq * D, koff = (size_t)g * Sk * D;
  const int* mg = kvm + (size_t)g * Sk;

  for (int c0 = kb * bk; c0 < kb * bk + bk; c0 += TL) {
    const int crows = min(TL, kb * bk + bk - c0);
    __syncthreads();
    load_tile<TL, DP>(Ks, LD, k + koff + (size_t)c0 * D, crows, D);
    load_tile<TL, DP>(Vs, LD, v + koff + (size_t)c0 * D, crows, D);
    for (int i = threadIdx.x; i < TL; i += kThreads) valid_s[i] = i < crows ? mg[c0 + i] : 0;
    A dk_acc[TM][TN], dv_acc[TM][TN];
    zero(dk_acc);
    zero(dv_acc);

    for (int r0 = q_lo; r0 < Sq; r0 += TL) {
      const int rows = min(TL, Sq - r0);
      __syncthreads();  // Q, dO, P and dS of the previous chunk have been read
      load_tile<TL, DP>(Qs, LD, q + qoff + (size_t)r0 * D, rows, D);
      load_tile<TL, DP>(dOs, LD, dout + qoff + (size_t)r0 * D, rows, D);
      for (int i = threadIdx.x; i < TL; i += kThreads) {
        const size_t at = (size_t)g * Sq + r0 + i;
        lse_s[i] = i < rows ? safe_lse(lse[at]) : A(0);
        delta_s[i] = i < rows ? delta[at] : A(0);
      }
      __syncthreads();

      // transposed scores: rows are keys (c), columns are queries (r)
      A s[TM][TM], dp[TM][TM];
      zero(s);
      zero(dp);
      tile_mma<TM, TM>(s, Ks, LD, 1, Qs, 1, LD, DP);    // k q^T
      tile_mma<TM, TM>(dp, Vs, LD, 1, dOs, 1, LD, DP);  // v dO^T
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          const int c = ty + 16 * i, r = tx + 16 * j;
          const bool keep = r < rows && valid_s[c] != 0 && (!causal || r0 + r >= c0 + c);
          const A p = keep ? exp_(s[i][j] * scale - lse_s[r]) : A(0);
          const A ds = p * (dp[i][j] - delta_s[r]) * scale;
          Ps[c * LS + r] = round_to<T, A>(p);    // p.astype(do.dtype)
          dSs[c * LS + r] = round_to<T, A>(ds);  // ds.astype(q.dtype)
        }
      }
      __syncthreads();
      tile_mma<TM, TN>(dv_acc, Ps, LS, 1, dOs, LD, 1, rows);  // dV += P^T dO
      tile_mma<TM, TN>(dk_acc, dSs, LS, 1, Qs, LD, 1, rows);  // dK += dS^T q
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int c = ty + 16 * i;
      if (c >= crows) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const size_t at = koff + (size_t)(c0 + c) * D + d;
          dk[at] = narrow<T, A>(dk_acc[i][j]);
          dv[at] = narrow<T, A>(dv_acc[i][j]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 / float16 forward and backward on the tensor cores (mma.sync
// m16n8k16, fp32 accumulators): one block of four warps owns 64 rows
// (queries in the forward and dQ, keys in dK/dV), 16 per warp; the other
// operand streams through shared memory in tiles double-buffered with
// cp.async
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // the block's own rows

template <typename T>
constexpr bool kTensorCore = std::is_same<T, __nv_bfloat16>::value || std::is_same<T, __half>::value;

template <int DP> struct MmaTiles {
  // a staged row is 16 bytes longer than the head, so the 8 rows one
  // ldmatrix reads start in 8 distinct groups of 4 banks: no conflict
  static constexpr int LD = DP + 8;
  static constexpr int kDqKeys = 64;                      // keys per step of dQ's loop
  static constexpr int kDqPass = 32;                      // ... and per pass of its scores
  static constexpr int kDkvQueries = DP <= 64 ? 64 : 32;  // queries per step of dK/dV's loop
  static constexpr int kDkvPass = 16;                     // ... and per pass of its scores
  static constexpr int kFwdKeys = 64;                     // keys per step of the forward's loop
  static constexpr bool kFwdHoldQ = DP <= 64;             // Q's A fragments kept in registers
  // resident blocks an SM must be able to hold (caps the registers at 128
  // a thread: four blocks of 128 threads; the smem of four fits); the
  // forward's scores of a whole 64-key tile need more: three, 168
  static constexpr int kMinBlocks = DP <= 64 ? 4 : 1;
  static constexpr int kFwdMinBlocks = DP <= 64 ? 3 : 1;
};

// rows x DP tile of a row-major (., D) operand into shared memory with row
// stride DP + 8; zeros where r >= rows or d >= D. With vec (D % 8 == 0,
// 16-byte aligned operands) as 16-byte cp.async copies in flight until
// waited for, else element by element.
template <int ROWS, int DP, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int rows, int D, bool vec) {
  constexpr int LD = DP + 8;
  if (vec) {
    constexpr int C = DP / 8;      // 16-byte chunks a row
    constexpr int STEP = kMmaThreads / C;   // rows the block covers at once
    const int d = (threadIdx.x % C) * 8;
#pragma unroll
    for (int r = threadIdx.x / C; r < ROWS; r += STEP) {
      const bool full = r < rows && d < D;
      mma_sm90::cp_async16(dst + r * LD + d, full ? src + (size_t)r * D + d : src, full);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kMmaThreads) {
      const int r = i / DP, d = i % DP;
      dst[r * LD + d] = (r < rows && d < D) ? src[(size_t)r * D + d] : narrow<T, float>(0.f);
    }
  }
}

// n entries of a 4-byte row vector (lse, delta, kvm) into shared memory by
// cp.async; zeros from entry `rows` on
template <typename V>
__device__ __forceinline__ void stage_vec(V* dst, const V* __restrict__ src, int n, int rows) {
  for (int i = threadIdx.x; i < n; i += kMmaThreads) {
    const bool full = i < rows;
    mma_sm90::cp_async4(dst + i, src + (full ? i : 0), full);
  }
}

// 2^x on the special-function unit (ex2.approx, about 2 ulp); +0 for the
// masked scores (NEG_INF) and for anything below -126 - 24
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// forward: block per (g, 64-row part of a q-block), the
// heads fastest and the heaviest (last) q-blocks first, as dQ; warp w owns
// the query rows 16w..16w+15 of the part. Keys 0 .. k_end (the reference's
// block skip) stream in tiles of kFwdKeys, double-buffered. Scores, the
// online softmax's running max m and the denominator l live in registers,
// in log2 units (s * scale * log2 e, p = 2^(s - m)); each lane sums l over
// its own key columns and the four lanes of a row add their sums at the end
// (alpha is the same on all four, so the partial sums rescale alike).
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads, MmaTiles<DP>::kFwdMinBlocks)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ kvm, T* __restrict__ out, float* __restrict__ lse,
              int* __restrict__ probe, int Sq, int Sk, int D, int bq, int bk, int causal, int vec) {
  using namespace mma_sm90;
  using Tiles = MmaTiles<DP>;
  constexpr int LD = Tiles::LD, BK = Tiles::kFwdKeys;
  constexpr int ROWS = kMmaRows;               // the block's own query rows
  constexpr int KS = DP / 16;                  // k16 steps over the head
  constexpr int NK = BK / 8;                   // n8 tiles over a tile of keys
  constexpr int ND = DP / 8;                   // n8 tiles over the head
  constexpr bool kHoldQ = Tiles::kFwdHoldQ;
  static_assert(kMmaThreads >= BK, "every key flag of a tile is read by one thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + ROWS * LD;     // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;   // [2][BK][LD]
  int* kvm_s = reinterpret_cast<int*>(Vs + 2 * BK * LD);  // [2][BK]

  // the heads fastest, the heaviest causal q-blocks (the last) first
  const int n_q = Sq / bq, parts = (bq + ROWS - 1) / ROWS;
  const int G = gridDim.x / (n_q * parts);
  const int g = blockIdx.x % G, rest = blockIdx.x / G;
  const int qb = n_q - 1 - rest / parts, part = rest % parts;
  const int r0 = qb * bq + part * ROWS;
  const int rows = min(ROWS, qb * bq + bq - r0);
  const int n_k = Sk / bk;
  const int kb_last = causal ? min(n_k - 1, (qb * bq + bq - 1) / bk) : n_k - 1;
  const int k_end = (kb_last + 1) * bk;  // the block skip: keys past it are never read
  // the probe (trip count in KV blocks of bk keys) has one writer a q-block
  if (part == 0 && threadIdx.x == 0) probe[(size_t)g * n_q + qb] = kb_last + 1;
  const size_t qoff = (size_t)g * Sq * D, koff = (size_t)g * Sk * D;
  const float sl2 = (float)(1.4426950408889634 / sqrt((double)D));  // scale * log2 e
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;

  auto stage_kv = [&](int buf, int c0) {
    const int cols = min(BK, k_end - c0);
    stage_tile<BK, DP>(Ks + buf * BK * LD, k + koff + (size_t)c0 * D, cols, D, vec);
    stage_tile<BK, DP>(Vs + buf * BK * LD, v + koff + (size_t)c0 * D, cols, D, vec);
    stage_vec(kvm_s + buf * BK, kvm + (size_t)g * Sk + c0, BK, cols);
  };
  stage_tile<ROWS, DP>(Qs, q + qoff + (size_t)r0 * D, rows, D, vec);
  cp_async_commit();
  stage_kv(0, 0);
  cp_async_commit();

  // this thread's two query rows: 16w + gr and 16w + gr + 8
  const int qr = warp * 16 + gr;
  const bool warp_live = warp * 16 < rows;
  cp_async_wait<1>();  // the Q tile has landed
  __syncthreads();
  uint32_t qa[kHoldQ ? KS : 1][4];  // Q's A fragments over the head, if held
  if constexpr (kHoldQ) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qa[ks], Qs + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {float(kNegInf), float(kNegInf)}, l[2] = {0.f, 0.f};

  int buf = 0;
  for (int c0 = 0; c0 < k_end; c0 += BK, buf ^= 1) {
    const int cols = min(BK, k_end - c0);
    if (c0 + BK < k_end) stage_kv(buf ^ 1, c0 + BK);
    cp_async_commit();  // possibly empty: the count of groups stays uniform
    cp_async_wait<1>();  // everything but the tile just requested has landed
    // every key of the tile valid? Thread i < BK reads the flag it copied
    const bool all_keys = __syncthreads_and(threadIdx.x >= BK || kvm_s[buf * BK + threadIdx.x] != 0);
    // causal: a warp whose last row lies before the tile's first key sees
    // none of it; skipping the tile leaves m, l and acc as they are, which
    // is what alpha 1 and p 0 would do
    const bool above = causal && c0 > r0 + warp * 16 + 15;
    if (warp_live && !above) {
      const T* Kb = Ks + buf * BK * LD;
      const T* Vb = Vs + buf * BK * LD;
      const int* mb = kvm_s + buf * BK;
      // masked scores are NEG_INF by select; a warp whose rows are live and
      // see every key of the tile (all keys valid, the tile below the causal
      // diagonal) masks nothing
      const bool interior = all_keys && warp * 16 + 16 <= rows && (!causal || r0 + warp * 16 >= c0 + BK - 1);
      // S = Q K^T over the head
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        if constexpr (kHoldQ) {
          a[0] = qa[ks][0]; a[1] = qa[ks][1]; a[2] = qa[ks][2]; a[3] = qa[ks][3];
        } else {
          ldmatrix_x4(a, Qs + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
        }
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, Kb + (np * 16 + lane % 8 + (lane / 16) * 8) * LD + ks * 16 + ((lane / 8) % 2) * 8);
          mma_16816<T>(s[2 * np], a, b[0], b[1]);
          mma_16816<T>(s[2 * np + 1], a, b[2], b[3]);
        }
      }
      // scale and mask, then the row max over the tile (the quad's 4 lanes)
      float mx[2] = {float(kNegInf), float(kNegInf)};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const int kc0 = n * 8 + 2 * tq;
        const int2 m2 = *reinterpret_cast<const int2*>(mb + kc0);
        const bool valid[2] = {m2.x != 0, m2.y != 0};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, kc = kc0 + e % 2;
          const bool keep = interior || (qr + 8 * h < rows && kc < cols && valid[e % 2] &&
                                         (!causal || r0 + qr + 8 * h >= c0 + kc));
          s[n][e] = keep ? s[n][e] * sl2 : float(kNegInf);
          mx[h] = fmaxf(mx[h], s[n][e]);
        }
      }
      float m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);
        // dead rows keep m_new == NEG_INF: exp against 0 underflows their
        // masked scores to 0 instead of exp(0) == 1; m - m_new is 0 there
        m_safe[h] = m_new > float(kDeadRow) ? m_new : 0.f;
        const float alpha = exp2_fast(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * h] *= alpha;
          acc[n][2 * h + 1] *= alpha;
        }
      }
      // p = 2^(s - m_safe); l sums the unrounded p, as the reference does;
      // p packed at once into the A fragments of P V (p.astype(v.dtype)),
      // half the registers of the fp32 scores
      uint32_t pa[NK / 2][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp2_fast(s[n][e] - m_safe[e / 2]);
          l[e / 2] += s[n][e];
        }
        if (n % 2 == 1) pack_a<T>(pa[n / 2], s[n - 1], s[n]);
      }
      // O += P V
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
#pragma unroll
        for (int dpair = 0; dpair < ND / 2; ++dpair) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, Vb + (j * 16 + lane % 16) * LD + dpair * 16 + (lane / 16) * 8);
          mma_16816<T>(acc[2 * dpair], pa[j], b[0], b[1]);
          mma_16816<T>(acc[2 * dpair + 1], pa[j], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer has been read before the next-but-one tile lands in it
  }
  cp_async_wait<0>();

  // out = acc / l (0 where l == 0), lse = m + log l (NEG_INF there); every
  // element has one writer
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = qr + 8 * h;
    if (r >= rows) continue;
    const bool live = l[h] > 0.f;
    T* orow = out + qoff + (size_t)(r0 + r) * D;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int d = n * 8 + 2 * tq;
      const float o0 = live ? acc[n][2 * h] / l[h] : 0.f, o1 = live ? acc[n][2 * h + 1] / l[h] : 0.f;
      if (vec) {  // D % 8 == 0 and 16-byte aligned rows: the pair as one word
        if (d < D) *reinterpret_cast<uint32_t*>(orow + d) = pack2<T>(o0, o1);
      } else {
        if (d < D) orow[d] = narrow<T, float>(o0);
        if (d + 1 < D) orow[d + 1] = narrow<T, float>(o1);
      }
    }
    if (tq == 0) lse[(size_t)g * Sq + r0 + r] = live ? m[h] * 0.6931471805599453f + logf(l[h]) : float(kNegInf);
  }
}

// dQ: block per (g, 64-row part of a q-block), the heads fastest and the
// heaviest (last) q-blocks first; warp w owns the query rows 16w..16w+15 of
// the part. Keys 0 .. k_end (the reference's block skip) stream in tiles of
// 64.
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads, MmaTiles<DP>::kMinBlocks)
flash_bwd_dq_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kvm, const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk, int D, int bq, int bk,
                 int causal, int vec) {
  using namespace mma_sm90;
  constexpr int LD = MmaTiles<DP>::LD, BK = MmaTiles<DP>::kDqKeys, KP = MmaTiles<DP>::kDqPass;
  constexpr int KS = DP / 16;  // k16 steps over the head
  constexpr int NP = KP / 8;   // n8 tiles over a pass of keys
  constexpr int ND = DP / 8;   // n8 tiles over the head
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + kMmaRows * LD;
  T* Ks = dOs + kMmaRows * LD;  // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;     // [2][BK][LD]
  int* kvm_s = reinterpret_cast<int*>(Vs + 2 * BK * LD);  // [2][BK]

  // the heads fastest, the heaviest causal q-blocks (the last) first
  const int n_q = Sq / bq, parts = (bq + kMmaRows - 1) / kMmaRows;
  const int G = gridDim.x / (n_q * parts);
  const int g = blockIdx.x % G, rest = blockIdx.x / G;
  const int qb = n_q - 1 - rest / parts;
  const int r0 = qb * bq + (rest % parts) * kMmaRows;
  const int rows = min(kMmaRows, qb * bq + bq - r0);
  const int n_k = Sk / bk;
  const int kb_last = causal ? min(n_k - 1, (qb * bq + bq - 1) / bk) : n_k - 1;
  const int k_end = (kb_last + 1) * bk;
  const size_t qoff = (size_t)g * Sq * D, koff = (size_t)g * Sk * D;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;

  auto stage_kv = [&](int buf, int c0) {
    const int cols = min(BK, k_end - c0);
    stage_tile<BK, DP>(Ks + buf * BK * LD, k + koff + (size_t)c0 * D, cols, D, vec);
    stage_tile<BK, DP>(Vs + buf * BK * LD, v + koff + (size_t)c0 * D, cols, D, vec);
    stage_vec(kvm_s + buf * BK, kvm + (size_t)g * Sk + c0, BK, cols);
  };
  stage_tile<kMmaRows, DP>(Qs, q + qoff + (size_t)r0 * D, rows, D, vec);
  stage_tile<kMmaRows, DP>(dOs, dout + qoff + (size_t)r0 * D, rows, D, vec);
  stage_kv(0, 0);
  cp_async_commit();

  // this thread's two query rows: 16w + gr and 16w + gr + 8
  const int qr = warp * 16 + gr;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = qr + 8 * h < rows;
    const size_t at = (size_t)g * Sq + r0 + qr + 8 * h;
    lse_r[h] = live ? safe_lse(lse[at]) : 0.f;
    delta_r[h] = live ? delta[at] : 0.f;
  }
  const bool warp_live = warp * 16 < rows;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int buf = 0;
  for (int c0 = 0; c0 < k_end; c0 += BK, buf ^= 1) {
    const int cols = min(BK, k_end - c0);
    if (c0 + BK < k_end) stage_kv(buf ^ 1, c0 + BK);
    cp_async_commit();  // possibly empty: the count of groups stays uniform
    cp_async_wait<1>();  // everything but the tile just requested has landed
    // every key of the tile valid? Thread i < BK reads the flag it copied
    const bool all_keys = __syncthreads_and(threadIdx.x >= BK || kvm_s[buf * BK + threadIdx.x] != 0);
    if (warp_live) {
      const T* Kb = Ks + buf * BK * LD;
      const T* Vb = Vs + buf * BK * LD;
      const int* mb = kvm_s + buf * BK;
      // masked entries of dS are exactly 0, by select; a warp whose rows are
      // live and see every key of the tile (all keys valid, the tile below
      // the causal diagonal) masks nothing
      const bool interior = all_keys && warp * 16 + 16 <= rows && (!causal || r0 + warp * 16 >= c0 + BK - 1);
      // the scores in passes of KP keys: fewer of them live in registers
#pragma unroll 1
      for (int k0 = 0; k0 < BK; k0 += KP) {
        float s[NP][4], dp[NP][4];
#pragma unroll
        for (int n = 0; n < NP; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
        }
        // S = Q K^T and dP = dO V^T over the head
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t qa[4], da[4];
          ldmatrix_x4(qa, Qs + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
          ldmatrix_x4(da, dOs + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
#pragma unroll
          for (int np = 0; np < NP / 2; ++np) {
            const int at = (k0 + np * 16 + lane % 8 + (lane / 16) * 8) * LD + ks * 16 + ((lane / 8) % 2) * 8;
            uint32_t b[4];
            ldmatrix_x4(b, Kb + at);
            mma_16816<T>(s[2 * np], qa, b[0], b[1]);
            mma_16816<T>(s[2 * np + 1], qa, b[2], b[3]);
            ldmatrix_x4(b, Vb + at);
            mma_16816<T>(dp[2 * np], da, b[0], b[1]);
            mma_16816<T>(dp[2 * np + 1], da, b[2], b[3]);
          }
        }
        // dS = P (dP - delta) scale into s
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const int kc0 = k0 + n * 8 + 2 * tq;
          const int2 m2 = *reinterpret_cast<const int2*>(mb + kc0);
          const bool valid[2] = {m2.x != 0, m2.y != 0};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e / 2, kc = kc0 + e % 2;
            const bool keep = interior || (qr + 8 * h < rows && kc < cols && valid[e % 2] &&
                                           (!causal || r0 + qr + 8 * h >= c0 + kc));
            const float p = __expf(s[n][e] * scale - lse_r[h]);
            s[n][e] = keep ? p * (dp[n][e] - delta_r[h]) * scale : 0.f;
          }
        }
        // dQ += dS K (ds.astype(k.dtype))
#pragma unroll
        for (int j = 0; j < NP / 2; ++j) {
          uint32_t dsa[4];
          pack_a<T>(dsa, s[2 * j], s[2 * j + 1]);
#pragma unroll
          for (int dpair = 0; dpair < ND / 2; ++dpair) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, Kb + (k0 + j * 16 + lane % 16) * LD + dpair * 16 + (lane / 16) * 8);
            mma_16816<T>(acc[2 * dpair], dsa, b[0], b[1]);
            mma_16816<T>(acc[2 * dpair + 1], dsa, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer has been read before the next-but-one tile lands in it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = qr + 8 * (e / 2), d = n * 8 + 2 * tq + e % 2;
      if (r < rows && d < D) dq[qoff + (size_t)(r0 + r) * D + d] = narrow<T, float>(acc[n][e]);
    }
  }
}

// dK / dV: block per (g, 64-row part of a kv-block), the heads fastest and
// the heaviest (first) kv-blocks first; warp w owns the key rows
// 16w..16w+15 of the part. Queries from the reference's causal start
// ((kb*bk)/bq)*bq to Sq stream in tiles of kDkvQueries with their lse and
// delta. Scores are formed transposed (rows keys, columns queries), so P^T
// and dS^T are A fragments of dV += P^T dO and dK += dS^T Q as they stand.
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads, MmaTiles<DP>::kMinBlocks)
flash_bwd_dkv_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ kvm, const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk,
                  int D, int bq, int bk, int causal, int vec) {
  using namespace mma_sm90;
  constexpr int LD = MmaTiles<DP>::LD, BQ = MmaTiles<DP>::kDkvQueries, QP = MmaTiles<DP>::kDkvPass;
  constexpr int KS = DP / 16;
  constexpr int NP = QP / 8;  // n8 tiles over a pass of queries
  constexpr int ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + kMmaRows * LD;
  T* Qs = Vs + kMmaRows * LD;  // [2][BQ][LD]
  T* dOs = Qs + 2 * BQ * LD;   // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* delta_s = lse_s + 2 * BQ;                              // [2][BQ]

  // the heads fastest, the heaviest causal kv-blocks (the first) first
  const int n_k = Sk / bk, parts = (bk + kMmaRows - 1) / kMmaRows;
  const int G = gridDim.x / (n_k * parts);
  const int g = blockIdx.x % G, rest = blockIdx.x / G;
  const int kb = rest / parts;
  const int c0 = kb * bk + (rest % parts) * kMmaRows;
  const int crows = min(kMmaRows, kb * bk + bk - c0);
  const int q_lo = causal ? ((kb * bk) / bq) * bq : 0;  // the block skip, from below
  const size_t qoff = (size_t)g * Sq * D, koff = (size_t)g * Sk * D;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;

  auto stage_q = [&](int buf, int r0) {
    const int rows = min(BQ, Sq - r0);
    stage_tile<BQ, DP>(Qs + buf * BQ * LD, q + qoff + (size_t)r0 * D, rows, D, vec);
    stage_tile<BQ, DP>(dOs + buf * BQ * LD, dout + qoff + (size_t)r0 * D, rows, D, vec);
    stage_vec(lse_s + buf * BQ, lse + (size_t)g * Sq + r0, BQ, rows);
    stage_vec(delta_s + buf * BQ, delta + (size_t)g * Sq + r0, BQ, rows);
  };
  stage_tile<kMmaRows, DP>(Ks, k + koff + (size_t)c0 * D, crows, D, vec);
  stage_tile<kMmaRows, DP>(Vs, v + koff + (size_t)c0 * D, crows, D, vec);
  if (q_lo < Sq) stage_q(0, q_lo);
  cp_async_commit();

  // this thread's two key rows: 16w + gr and 16w + gr + 8
  const int kr = warp * 16 + gr;
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) key_ok[h] = kr + 8 * h < crows && kvm[(size_t)g * Sk + c0 + kr + 8 * h] != 0;
  const bool warp_live = warp * 16 < crows;
  const bool all_keys = __syncthreads_and(key_ok[0] && key_ok[1]);  // all 64 keys live and valid

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  int buf = 0;
  for (int r0 = q_lo; r0 < Sq; r0 += BQ, buf ^= 1) {
    const int rows = min(BQ, Sq - r0);
    if (r0 + BQ < Sq) stage_q(buf ^ 1, r0 + BQ);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (warp_live) {
      const T* Qb = Qs + buf * BQ * LD;
      const T* dOb = dOs + buf * BQ * LD;
      const float* lb = lse_s + buf * BQ;
      const float* db = delta_s + buf * BQ;
      // masked entries of P^T and dS^T are exactly 0, by select; a warp
      // whose keys are all valid and below every query of the tile (the
      // causal diagonal passed) masks nothing
      const bool interior = all_keys && rows == BQ && (!causal || r0 >= c0 + warp * 16 + 15);
      // the scores in passes of QP queries: fewer of them live in registers
#pragma unroll 1
      for (int q0 = 0; q0 < BQ; q0 += QP) {
        float s[NP][4], dp[NP][4];
#pragma unroll
        for (int n = 0; n < NP; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
        }
        // S^T = K Q^T and dP^T = V dO^T over the head
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t ka[4], va[4];
          ldmatrix_x4(ka, Ks + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
          ldmatrix_x4(va, Vs + (warp * 16 + lane % 16) * LD + ks * 16 + (lane / 16) * 8);
#pragma unroll
          for (int np = 0; np < NP / 2; ++np) {
            const int at = (q0 + np * 16 + lane % 8 + (lane / 16) * 8) * LD + ks * 16 + ((lane / 8) % 2) * 8;
            uint32_t b[4];
            ldmatrix_x4(b, Qb + at);
            mma_16816<T>(s[2 * np], ka, b[0], b[1]);
            mma_16816<T>(s[2 * np + 1], ka, b[2], b[3]);
            ldmatrix_x4(b, dOb + at);
            mma_16816<T>(dp[2 * np], va, b[0], b[1]);
            mma_16816<T>(dp[2 * np + 1], va, b[2], b[3]);
          }
        }
        // P^T into s, dS^T into dp
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const int qc0 = q0 + n * 8 + 2 * tq;
          const float2 l2 = *reinterpret_cast<const float2*>(lb + qc0);
          const float2 d2 = *reinterpret_cast<const float2*>(db + qc0);
          const float lsafe[2] = {safe_lse(l2.x), safe_lse(l2.y)}, dl[2] = {d2.x, d2.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e / 2, qc = qc0 + e % 2;
            const bool keep = interior || (key_ok[h] && qc < rows && (!causal || r0 + qc >= c0 + kr + 8 * h));
            const float p = __expf(s[n][e] * scale - lsafe[e % 2]);
            const float ds = p * (dp[n][e] - dl[e % 2]) * scale;
            s[n][e] = keep ? p : 0.f;
            dp[n][e] = keep ? ds : 0.f;
          }
        }
        // dV += P^T dO (p.astype(do.dtype)), dK += dS^T Q (ds.astype(q.dtype))
#pragma unroll
        for (int j = 0; j < NP / 2; ++j) {
          uint32_t pa[4], dsa[4];
          pack_a<T>(pa, s[2 * j], s[2 * j + 1]);
          pack_a<T>(dsa, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
          for (int dpair = 0; dpair < ND / 2; ++dpair) {
            const int at = (q0 + j * 16 + lane % 16) * LD + dpair * 16 + (lane / 16) * 8;
            uint32_t b[4];
            ldmatrix_x4_trans(b, dOb + at);
            mma_16816<T>(dv_acc[2 * dpair], pa, b[0], b[1]);
            mma_16816<T>(dv_acc[2 * dpair + 1], pa, b[2], b[3]);
            ldmatrix_x4_trans(b, Qb + at);
            mma_16816<T>(dk_acc[2 * dpair], dsa, b[0], b[1]);
            mma_16816<T>(dk_acc[2 * dpair + 1], dsa, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = kr + 8 * (e / 2), d = n * 8 + 2 * tq + e % 2;
      if (c < crows && d < D) {
        const size_t at = koff + (size_t)(c0 + c) * D + d;
        dk[at] = narrow<T, float>(dk_acc[n][e]);
        dv[at] = narrow<T, float>(dv_acc[n][e]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// 16-byte cp.async copies (and the forward's paired stores) need D % 8 == 0
// and 16-byte aligned operands
inline int vec16(const Params& p) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
                         reinterpret_cast<uintptr_t>(p.v) | reinterpret_cast<uintptr_t>(p.dout) |
                         reinterpret_cast<uintptr_t>(p.out);
  return p.D % 8 == 0 && bits % 16 == 0;
}

template <typename T, int DP> struct FwdMma {
  static int run(const Params& p, cudaStream_t s) {
    using Tiles = MmaTiles<DP>;
    constexpr int LD = Tiles::LD, BK = Tiles::kFwdKeys;
    const size_t smem = (kMmaRows + 4 * BK) * LD * sizeof(T) + 2 * BK * sizeof(int);
    auto kernel = flash_fwd_mma<T, DP>;
    if (int e = prepare(kernel, smem)) return e;
    const long long blocks = (long long)p.G * (p.Sq / p.bq) * ((p.bq + kMmaRows - 1) / kMmaRows);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, kMmaThreads, smem, s>>>(
        static_cast<const T*>(p.q), static_cast<const T*>(p.k), static_cast<const T*>(p.v), p.kvm,
        static_cast<T*>(p.out), static_cast<float*>(p.lse), p.probe, p.Sq, p.Sk, p.D, p.bq, p.bk, p.causal,
        vec16(p));
    return (int)cudaGetLastError();
  }
};

// bfloat16 and float16 take the tensor-core forward; float32 and float64
// the CUDA-core one (true fp32 / fp64 FMAs)
template <typename T, typename A, int DP> struct Fwd {
  static int run(const Params& p, cudaStream_t s) {
    if constexpr (kTensorCore<T>) {
      return FwdMma<T, DP>::run(p, s);
    } else {
      constexpr int TL = Tile<A>::value, LD = DP + 1, LS = TL + 1;
      const size_t smem = (3 * TL * LD + TL * LS + 3 * TL) * sizeof(A) + TL * sizeof(int);
      auto kernel = flash_fwd_kernel<T, A, DP>;
      if (int e = prepare(kernel, smem)) return e;
      kernel<<<dim3(p.G, p.Sq / p.bq), kThreads, smem, s>>>(
          static_cast<const T*>(p.q), static_cast<const T*>(p.k), static_cast<const T*>(p.v), p.kvm,
          static_cast<T*>(p.out), static_cast<A*>(p.lse), p.probe, p.Sq, p.Sk, p.D, p.bq, p.bk, p.causal);
      return (int)cudaGetLastError();
    }
  }
};


template <typename T, int DP> struct BwdDqMma {
  static int run(const Params& p, cudaStream_t s) {
    constexpr int LD = MmaTiles<DP>::LD, BK = MmaTiles<DP>::kDqKeys;
    const size_t smem = (2 * kMmaRows + 4 * BK) * LD * sizeof(T) + 2 * BK * sizeof(int);
    auto kernel = flash_bwd_dq_mma<T, DP>;
    if (int e = prepare(kernel, smem)) return e;
    const long long blocks = (long long)p.G * (p.Sq / p.bq) * ((p.bq + kMmaRows - 1) / kMmaRows);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, kMmaThreads, smem, s>>>(
        static_cast<const T*>(p.q), static_cast<const T*>(p.k), static_cast<const T*>(p.v), p.kvm,
        static_cast<const T*>(p.dout), static_cast<const float*>(p.lse_in), static_cast<const float*>(p.delta),
        static_cast<T*>(p.dq), p.Sq, p.Sk, p.D, p.bq, p.bk, p.causal, vec16(p));
    return (int)cudaGetLastError();
  }
};

template <typename T, int DP> struct BwdDkvMma {
  static int run(const Params& p, cudaStream_t s) {
    constexpr int LD = MmaTiles<DP>::LD, BQ = MmaTiles<DP>::kDkvQueries;
    const size_t smem = (2 * kMmaRows + 4 * BQ) * LD * sizeof(T) + 4 * BQ * sizeof(float);
    auto kernel = flash_bwd_dkv_mma<T, DP>;
    if (int e = prepare(kernel, smem)) return e;
    const long long blocks = (long long)p.G * (p.Sk / p.bk) * ((p.bk + kMmaRows - 1) / kMmaRows);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, kMmaThreads, smem, s>>>(
        static_cast<const T*>(p.q), static_cast<const T*>(p.k), static_cast<const T*>(p.v), p.kvm,
        static_cast<const T*>(p.dout), static_cast<const float*>(p.lse_in), static_cast<const float*>(p.delta),
        static_cast<T*>(p.dk), static_cast<T*>(p.dv), p.Sq, p.Sk, p.D, p.bq, p.bk, p.causal, vec16(p));
    return (int)cudaGetLastError();
  }
};

// bfloat16 and float16 take the tensor-core kernels; float32 and float64
// the CUDA-core ones (true fp32 / fp64 FMAs)
template <typename T, typename A, int DP> struct BwdDq {
  static int run(const Params& p, cudaStream_t s) {
    if constexpr (kTensorCore<T>) {
      return BwdDqMma<T, DP>::run(p, s);
    } else {
      constexpr int TL = Tile<A>::value, LD = DP + 1, LS = TL + 1;
      const size_t smem = (4 * TL * LD + TL * LS + 2 * TL) * sizeof(A) + TL * sizeof(int);
      auto kernel = flash_bwd_dq_kernel<T, A, DP>;
      if (int e = prepare(kernel, smem)) return e;
      kernel<<<dim3(p.G, p.Sq / p.bq), kThreads, smem, s>>>(
          static_cast<const T*>(p.q), static_cast<const T*>(p.k), static_cast<const T*>(p.v), p.kvm,
          static_cast<const T*>(p.dout), static_cast<const A*>(p.lse_in), static_cast<const A*>(p.delta),
          static_cast<T*>(p.dq), p.Sq, p.Sk, p.D, p.bq, p.bk, p.causal);
      return (int)cudaGetLastError();
    }
  }
};

template <typename T, typename A, int DP> struct BwdDkv {
  static int run(const Params& p, cudaStream_t s) {
    if constexpr (kTensorCore<T>) {
      return BwdDkvMma<T, DP>::run(p, s);
    } else {
      constexpr int TL = Tile<A>::value, LD = DP + 1, LS = TL + 1;
      const size_t smem = (4 * TL * LD + 2 * TL * LS + 2 * TL) * sizeof(A) + TL * sizeof(int);
      auto kernel = flash_bwd_dkv_kernel<T, A, DP>;
      if (int e = prepare(kernel, smem)) return e;
      kernel<<<dim3(p.G, p.Sk / p.bk), kThreads, smem, s>>>(
          static_cast<const T*>(p.q), static_cast<const T*>(p.k), static_cast<const T*>(p.v), p.kvm,
          static_cast<const T*>(p.dout), static_cast<const A*>(p.lse_in), static_cast<const A*>(p.delta),
          static_cast<T*>(p.dk), static_cast<T*>(p.dv), p.Sq, p.Sk, p.D, p.bq, p.bk, p.causal);
      return (int)cudaGetLastError();
    }
  }
};

// head dims are padded to 16, 64 or 128 inside the kernel (zero columns)
template <template <typename, typename, int> class L, typename T, typename A>
int by_head_dim(const Params& p, cudaStream_t s) {
  if (p.D <= 16) return L<T, A, 16>::run(p, s);
  if (p.D <= 64) return L<T, A, 64>::run(p, s);
  return L<T, A, 128>::run(p, s);
}

template <template <typename, typename, int> class L>
int dispatch(int dtype, const Params& p, void* stream) {
  const bool ok = p.G >= 1 && p.D >= 1 && p.D <= 128 && p.bq >= 1 && p.bk >= 1 && p.Sq >= p.bq &&
                  p.Sk >= p.bk && p.Sq % p.bq == 0 && p.Sk % p.bk == 0 && p.Sq / p.bq <= 65535 &&
                  p.Sk / p.bk <= 65535;
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_head_dim<L, float, float>(p, s);
    case 1: return by_head_dim<L, __nv_bfloat16, float>(p, s);
    case 2: return by_head_dim<L, __half, float>(p, s);
    case 3: return by_head_dim<L, double, double>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out (G,Sq,D) in the operands' dtype, lse (G,Sq) float32 (float64 for
// float64 operands), probe (G, Sq/bq) int32
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, const void* kvm, void* out,
                               void* lse, void* probe, int G, int Sq, int Sk, int D, int bq, int bk,
                               int causal, int dtype, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.kvm = static_cast<const int*>(kvm);
  p.out = out; p.lse = lse; p.probe = static_cast<int*>(probe);
  p.G = G; p.Sq = Sq; p.Sk = Sk; p.D = D; p.bq = bq; p.bk = bk; p.causal = causal;
  return dispatch<Fwd>(dtype, p, stream);
}

// dout (G,Sq,D) in the operands' dtype; lse and delta (G,Sq) in the
// accumulator type; dq (G,Sq,D)
extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v, const void* kvm,
                                  const void* dout, const void* lse, const void* delta, void* dq, int G,
                                  int Sq, int Sk, int D, int bq, int bk, int causal, int dtype,
                                  void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.kvm = static_cast<const int*>(kvm);
  p.dout = dout; p.lse_in = lse; p.delta = delta; p.dq = dq;
  p.G = G; p.Sq = Sq; p.Sk = Sk; p.D = D; p.bq = bq; p.bk = bk; p.causal = causal;
  return dispatch<BwdDq>(dtype, p, stream);
}

// dk, dv (G,Sk,D)
extern "C" int repro_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* kvm,
                                   const void* dout, const void* lse, const void* delta, void* dk,
                                   void* dv, int G, int Sq, int Sk, int D, int bq, int bk, int causal,
                                   int dtype, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.kvm = static_cast<const int*>(kvm);
  p.dout = dout; p.lse_in = lse; p.delta = delta; p.dk = dk; p.dv = dv;
  p.G = G; p.Sq = Sq; p.Sk = Sk; p.D = D; p.bq = bq; p.bk = bk; p.causal = causal;
  return dispatch<BwdDkv>(dtype, p, stream);
}
