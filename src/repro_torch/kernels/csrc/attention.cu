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
//  - float32, bfloat16 and float16 operands accumulate in float32 with true
//    fp32 FMAs (no TF32); float64 operands accumulate in float64 and lse,
//    delta are float64 then (float32 otherwise).
//
// What bounds it on an H100 at the training shape (B 4, H 32, S 2048,
// D 64, bf16, causal): about 516 operations per byte moved (the causal
// forward is 4*G*S^2*D/2 = 6.9e10 FLOP over 134 MB of q, k, v and out), far
// above the card's ridge of ~295 for bf16: arithmetic, not memory. The
// card's bound is its bf16 tensor-core rate; this first version runs on the
// CUDA cores in fp32 (67 TFLOP/s), so its own ceiling is ~15x the card's
// bound.
//
// What the design does about it:
//  - Nothing O(S^2) reaches device memory: each (64 x 64) score tile (32 x
//    32 for float64) lives in shared memory only, the backward recomputes p
//    from q, k and the saved lse.
//  - Operand tiles are staged in shared memory in the accumulator type,
//    rows padded by one element so that the transposed reads (K^T, Q^T)
//    hit distinct banks; every tile product is a 16 x 16 thread grid in
//    which each thread owns a 4 x 4 (2 x 2) micro-tile of the scores and a
//    4 x (D/16) micro-tile of the accumulator, in registers, and reads one
//    column of A (a broadcast) and one row of B (consecutive) per k.
//  - The row statistics of the online softmax are reduced by the 4 (8)
//    threads of a row with warp shuffles.
//  - Heavy causal blocks are scheduled first (the forward and dQ take
//    q-blocks from the last; dK/dV's heavy blocks are the first kv-blocks).
// Tensor-core instructions (mma.sync / wgmma), TMA and warp specialisation
// are what a faster version would add.
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
#include <stdint.h>

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
// forward: one block per (g, q-block); KV loop up to the causal bound
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
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, typename A, int DP> struct Fwd {
  static int run(const Params& p, cudaStream_t s) {
    constexpr int TL = Tile<A>::value, LD = DP + 1, LS = TL + 1;
    const size_t smem = (3 * TL * LD + TL * LS + 3 * TL) * sizeof(A) + TL * sizeof(int);
    auto kernel = flash_fwd_kernel<T, A, DP>;
    if (int e = prepare(kernel, smem)) return e;
    kernel<<<dim3(p.G, p.Sq / p.bq), kThreads, smem, s>>>(
        static_cast<const T*>(p.q), static_cast<const T*>(p.k), static_cast<const T*>(p.v), p.kvm,
        static_cast<T*>(p.out), static_cast<A*>(p.lse), p.probe, p.Sq, p.Sk, p.D, p.bq, p.bk, p.causal);
    return (int)cudaGetLastError();
  }
};

template <typename T, typename A, int DP> struct BwdDq {
  static int run(const Params& p, cudaStream_t s) {
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
};

template <typename T, typename A, int DP> struct BwdDkv {
  static int run(const Params& p, cudaStream_t s) {
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
