// Chunked decayed linear attention (the SSD / mLSTM scan), forward only:
//   state_t = exp(log_decay_t) * state_{t-1} + scale_t * k_t v_t^T
//   y_t     = q_t . state_t
// q, k (BH,S,N), v (BH,S,P), log_decay and scale (BH,S) -> y (BH,S,P) in v's
// dtype. Operands float32, bfloat16 or float16 compute in float32 (as the
// reference's .astype(float32) does); float64 operands compute in float64.
//
// Replaces: repro/kernels/ssm_scan.py::_ssm_kernel (wrapper `ssm_scan`).
// There the chunk axis is the innermost TPU grid axis, so chunks run in
// order and the (N,P) fp32 state lives in VMEM scratch from one grid step to
// the next. Here blocks run in no order, so the chunk loop sits inside the
// block and the state in its shared memory. Per chunk, as the reference:
//   cd      = cumsum(log_decay)                        (within the chunk)
//   y       = exp(cd) * (q . state)                     cross-chunk term
//           + (tril(q . k^T * exp(cd_i - cd_j)) * scale_j) . v
//   state   = state * exp(cd_last) + (k * scale * exp(cd_last - cd))^T . v
//
// The state does not fit one block at every shape: at xlstm-1.3b's layer
// (N = 512, P = 1025: the ones column of v_aug makes P odd) it is 2.1 MB in
// float32, and a block has 227 KB. Its columns are independent — y[:, p]
// needs only state[:, p] and v[:, p] — so each block takes one (bh, p-tile)
// of TP columns (64 in float32, 32 in float64) and keeps its (N, TP) slice
// of the state in shared memory; the last tile masks P's ragged edge. Every
// p-tile of one bh recomputes that chunk's q . k^T and decay mask: at
// xlstm-1.3b's shape 17 tiles do it 17 times. That redundancy is the price
// of this first kernel; at zamba2-7b's (N = 64, P = 64) one tile holds the
// whole state and nothing is repeated.
//
// What bounds it on an H100: the products, about c(c+1)(N + P) + 4cNP
// operations per (bh, chunk of c) — q.k^T and w.v over the causal pairs,
// q.state and the state update — in float32 on the CUDA cores (67
// TFLOP/s): 0.67 ms at zamba2-7b's layer (batch 4 x 2048 tokens), 1.2 ms at
// xlstm-1.3b's, while the bytes come to about 0.3 ms.
//
// What the design does about it: rows of the chunk go in tiles of 32, keys
// in tiles of 32 up to the diagonal (the causal half only), the state
// dimension in slices of 32 staged in shared memory (padded rows: no bank
// conflicts); each thread keeps a 2-row micro-tile of the output in
// registers and reads its operands as broadcasts. The decay mask is a
// select, never a multiply by 0/1: for j > i, exp(cd_i - cd_j) may be inf,
// and inf * 0 would be NaN. No tensor cores yet (mma.sync / wgmma are a
// later step); the cross-chunk term is taken in the first key tile's pass
// over q, so q is read once for it.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing and returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 32;                 // rows of the chunk per tile
constexpr int kJ = 32;                 // keys per tile of the within-chunk product
constexpr int kNK = 32;                // state rows per staged slice
constexpr int kMaxSmem = 232448;       // bytes of shared memory a block may opt into

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }

template <typename TOut, typename Acc> struct Narrow;
template <> struct Narrow<float, float> {
  static __device__ __forceinline__ float of(float v) { return v; }
};
template <> struct Narrow<__nv_bfloat16, float> {
  static __device__ __forceinline__ __nv_bfloat16 of(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Narrow<__half, float> {
  static __device__ __forceinline__ __half of(float v) { return __float2half_rn(v); }
};
template <> struct Narrow<double, double> {
  static __device__ __forceinline__ double of(double v) { return v; }
};

// rows [r0, r0 + 32) x columns [c0, c0 + 32) of a (rows_total, ld) array
// into dst[32][33], zero outside; `row_scale` (or null) multiplies row r
template <typename T, typename Acc>
__device__ __forceinline__ void stage32(Acc* dst, const T* src, int r0, int rows_total, int c0, int cols_total,
                                        int ld, const Acc* row_scale) {
  for (int e = threadIdx.x; e < 32 * 32; e += kThreads) {
    const int r = e / 32, c = e % 32;
    Acc val = 0;
    if (r0 + r < rows_total && c0 + c < cols_total) {
      val = widen(src[(size_t)(r0 + r) * ld + c0 + c]);
      if (row_scale != nullptr) val *= row_scale[r0 + r];
    }
    dst[r * 33 + c] = val;
  }
}

// rows [r0, r0 + 32) x columns [p0, p0 + TP) of v (rows_total, P) into
// dst[32][TP], zero outside
template <typename T, typename Acc, int TP>
__device__ __forceinline__ void stage_v(Acc* dst, const T* src, int r0, int rows_total, int p0, int P) {
  for (int e = threadIdx.x; e < 32 * TP; e += kThreads) {
    const int r = e / TP, c = e % TP;
    Acc val = 0;
    if (r0 + r < rows_total && p0 + c < P) val = widen(src[(size_t)(r0 + r) * P + p0 + c]);
    dst[e] = val;
  }
}

template <typename Acc, int TP>
inline size_t smem_elems(int N, int C) {
  const size_t np = (size_t)(N + kNK - 1) / kNK * kNK;
  return np * TP + (size_t)kR * (kNK + 1) + (size_t)kJ * (kNK + 1) + (size_t)kJ * TP + (size_t)kR * (kJ + 1) +
         4 * (size_t)C;
}

template <typename T, typename Acc, int TP>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const Acc* __restrict__ ld, const Acc* __restrict__ sc, T* __restrict__ y, int S, int N, int P,
                int C) {
  constexpr int CPT = TP / 16;  // columns per thread, 16 apart
  const int NP = (N + kNK - 1) / kNK * kNK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* st = reinterpret_cast<Acc*>(smem_raw);  // [NP][TP] state slice; rows >= N stay 0
  Acc* qs = st + (size_t)NP * TP;              // [kR][kNK + 1]
  Acc* ks = qs + kR * (kNK + 1);               // [kJ][kNK + 1]
  Acc* vs = ks + kJ * (kNK + 1);               // [kJ][TP]
  Acc* wsm = vs + kJ * TP;                     // [kR][kJ + 1] decay-masked scores
  Acc* cd = wsm + kR * (kJ + 1);               // [C] cumsum of log_decay in the chunk
  Acc* ecd = cd + C;                           // [C] exp(cd)
  Acc* scs = ecd + C;                          // [C] scale
  Acc* gk = scs + C;                           // [C] scale * exp(cd_last - cd)

  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16, lane = tid % 32;
  const int bh = blockIdx.y, p0 = blockIdx.x * TP;
  const T* qb = q + (size_t)bh * S * N;
  const T* kb = k + (size_t)bh * S * N;
  const T* vb = v + (size_t)bh * S * P;
  const Acc* ldb = ld + (size_t)bh * S;
  const Acc* scb = sc + (size_t)bh * S;
  T* yb = y + (size_t)bh * S * P;

  for (int i = tid; i < NP * TP; i += kThreads) st[i] = 0;

  for (int t0 = 0; t0 < S; t0 += C) {
    const T* qc = qb + (size_t)t0 * N;
    const T* kc = kb + (size_t)t0 * N;
    const T* vc = vb + (size_t)t0 * P;
    __syncthreads();  // the previous chunk is done with cd and the state
    if (tid < 32) {   // cd = cumsum(log_decay): a segment per lane, then a warp scan
      const int seg = (C + 31) / 32;
      const int lo = min(C, lane * seg), hi = min(C, lo + seg);
      Acc run = 0;
      for (int i = lo; i < hi; ++i) {
        run += ldb[t0 + i];
        cd[i] = run;
      }
      Acc incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const Acc o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      Acc excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0;
      for (int i = lo; i < hi; ++i) cd[i] += excl;
    }
    __syncthreads();
    const Acc cd_last = cd[C - 1];
    for (int i = tid; i < C; i += kThreads) {
      const Acc s = scb[t0 + i];
      ecd[i] = ex(cd[i]);
      scs[i] = s;
      gk[i] = s * ex(cd_last - cd[i]);
    }
    __syncthreads();

    // ---- y for the chunk, one tile of kR rows at a time ----
    for (int i0 = 0; i0 < C; i0 += kR) {
      Acc acc[2][CPT];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int u = 0; u < CPT; ++u) acc[a][u] = 0;
      }
      const int j_end = min(C, i0 + kR);  // keys up to the tile's last row
      for (int j0 = 0; j0 < j_end; j0 += kJ) {
        Acc s2[2][2] = {{0, 0}, {0, 0}};
        for (int n0 = 0; n0 < NP; n0 += kNK) {
          stage32<T, Acc>(qs, qc, i0, C, n0, N, N, nullptr);
          stage32<T, Acc>(ks, kc, j0, C, n0, N, N, nullptr);
          __syncthreads();
#pragma unroll 8
          for (int nn = 0; nn < kNK; ++nn) {
            const Acc a0 = qs[(2 * tr) * (kNK + 1) + nn], a1 = qs[(2 * tr + 1) * (kNK + 1) + nn];
            const Acc b0 = ks[tc * (kNK + 1) + nn], b1 = ks[(tc + 16) * (kNK + 1) + nn];
            s2[0][0] += a0 * b0;
            s2[0][1] += a0 * b1;
            s2[1][0] += a1 * b0;
            s2[1][1] += a1 * b1;
            if (j0 == 0) {  // the cross-chunk term q . state, in the first key tile's pass
              const Acc* srow = st + (size_t)(n0 + nn) * TP + tc;
#pragma unroll
              for (int u = 0; u < CPT; ++u) {
                const Acc sv = srow[16 * u];
                acc[0][u] += a0 * sv;
                acc[1][u] += a1 * sv;
              }
            }
          }
          __syncthreads();
        }
        if (j0 == 0) {  // y_off = exp(cd) * (q . state)
#pragma unroll
          for (int a = 0; a < 2; ++a) {
            const int i = i0 + 2 * tr + a;
            const Acc e = i < C ? ecd[i] : Acc(0);
#pragma unroll
            for (int u = 0; u < CPT; ++u) acc[a][u] *= e;
          }
        }
        // decay mask by select (exp(cd_i - cd_j) may be inf for j > i)
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int i = i0 + 2 * tr + a, j = j0 + tc + 16 * b;
            Acc w = 0;
            if (i < C && j <= i) w = s2[a][b] * ex(cd[i] - cd[j]) * scs[j];
            wsm[(2 * tr + a) * (kJ + 1) + tc + 16 * b] = w;
          }
        }
        stage_v<T, Acc, TP>(vs, vc, j0, C, p0, P);
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < kJ; ++jj) {
          const Acc w0 = wsm[(2 * tr) * (kJ + 1) + jj], w1 = wsm[(2 * tr + 1) * (kJ + 1) + jj];
#pragma unroll
          for (int u = 0; u < CPT; ++u) {
            const Acc vv = vs[jj * TP + tc + 16 * u];
            acc[0][u] += w0 * vv;
            acc[1][u] += w1 * vv;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int i = i0 + 2 * tr + a;
#pragma unroll
        for (int u = 0; u < CPT; ++u) {
          const int p = p0 + tc + 16 * u;
          if (i < C && p < P) yb[(size_t)(t0 + i) * P + p] = Narrow<T, Acc>::of(acc[a][u]);
        }
      }
    }

    // ---- state = state * exp(cd_last) + (k * gk)^T . v ----
    __syncthreads();  // every row tile has read the state of the chunk's start
    const Acc decay = ex(cd_last);
    for (int n0 = 0; n0 < N; n0 += kNK) {
      Acc up[2][CPT];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int u = 0; u < CPT; ++u) up[a][u] = 0;
      }
      for (int j0 = 0; j0 < C; j0 += kJ) {
        stage32<T, Acc>(ks, kc, j0, C, n0, N, N, gk);  // ks[j][n] = k[j][n0 + n] * gk[j]
        stage_v<T, Acc, TP>(vs, vc, j0, C, p0, P);
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < kJ; ++jj) {
          const Acc k0 = ks[jj * (kNK + 1) + 2 * tr], k1 = ks[jj * (kNK + 1) + 2 * tr + 1];
#pragma unroll
          for (int u = 0; u < CPT; ++u) {
            const Acc vv = vs[jj * TP + tc + 16 * u];
            up[0][u] += k0 * vv;
            up[1][u] += k1 * vv;
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int n = n0 + 2 * tr + a;
        if (n < N) {
#pragma unroll
          for (int u = 0; u < CPT; ++u) {
            Acc* s = st + (size_t)n * TP + tc + 16 * u;
            *s = *s * decay + up[a][u];
          }
        }
      }
    }
  }
}

template <typename T, typename Acc, int TP>
int launch(const void* q, const void* k, const void* v, const void* ld, const void* sc, void* y, int BH, int S,
           int N, int P, int C, cudaStream_t stream) {
  const size_t smem = smem_elems<Acc, TP>(N, C) * sizeof(Acc);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ssm_scan_kernel<T, Acc, TP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P + TP - 1) / TP, BH);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<const Acc*>(ld),
                                           static_cast<const Acc*>(sc), static_cast<T*>(y), S, N, P, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 float64 — of q, k, v and
// y, all contiguous. log_decay and scale are float32 (float64 for float64
// operands). S % C == 0; 1 <= BH <= 65535.
extern "C" int repro_ssm_scan(const void* q, const void* k, const void* v, const void* ld, const void* sc, void* y,
                              int BH, int S, int N, int P, int C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH < 1 || BH > 65535 || S < 1 || N < 1 || P < 1 || C < 1 || S % C != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float, float, 64>(q, k, v, ld, sc, y, BH, S, N, P, C, s);
    case 1: return launch<__nv_bfloat16, float, 64>(q, k, v, ld, sc, y, BH, S, N, P, C, s);
    case 2: return launch<__half, float, 64>(q, k, v, ld, sc, y, BH, S, N, P, C, s);
    case 3: return launch<double, double, 32>(q, k, v, ld, sc, y, BH, S, N, P, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Bytes of shared memory one block of repro_ssm_scan takes at state rows N
// and chunk C for operands of `dtype`, and the most a block may opt into:
// the wrapper raises where the first exceeds the second (a size past INT_MAX
// reads as INT_MAX).
extern "C" int repro_ssm_scan_smem_bytes(int N, int C, int dtype) {
  if (N < 1 || C < 1) return -1;
  const size_t bytes = dtype == 3 ? smem_elems<double, 32>(N, C) * sizeof(double)
                                  : smem_elems<float, 64>(N, C) * sizeof(float);
  return bytes > (size_t)INT_MAX ? INT_MAX : (int)bytes;
}

extern "C" int repro_ssm_scan_smem_limit() { return kMaxSmem; }
