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
// the next. Per chunk of c rows, with cd = cumsum(log_decay) inside the chunk
// and gk = scale * exp(cd_last - cd):
//   y     = exp(cd) * (q . S_in) + (tril(q . k^T * exp(cd_i - cd_j)) * scale_j) . v
//   S_out = S_in * exp(cd_last) + (k * gk)^T . v
//
// What bounds it on an H100: the products, about c(c+1)(N + P) + 4cNP
// operations per (bh, chunk) — q.k^T and w.v over the causal pairs, q.S_in
// and the chunk's state — in float32 on the CUDA cores (67 TFLOP/s; the
// reference computes in fp32): 0.67 ms at zamba2-7b's layer (batch 4 x 2048
// tokens: BH 448, N 64, P 64, chunk 256), 1.2 ms at xlstm-1.3b's (BH 16,
// N 512, P 1025: the ones column of v_aug makes P odd), while the bytes
// come to about 0.3 ms.
//
// What the design does about it: SSD's chunk-parallel decomposition, passes
// launched by one call, so that no block walks the chunks in order and
// nothing is computed twice:
//  1. chunk states: dS_c = (k * gk)^T . v, an N x P block per (bh, chunk),
//     parallel over (bh, chunk, n-tile, p-tile). The last chunk's is not
//     needed. Also exp(cd_last) per (bh, chunk).
//  2. state passing: S_in of chunk c+1 = S_in(c) * exp(cd_last,c) + dS_c,
//     in order over chunks and parallel over the N x P elements, in place
//     in the scratch of pass 1: slot c then holds the state ENTERING chunk
//     c + 1 (chunk 0 enters with zeros). A bandwidth pass.
//  3. outputs, per (bh, chunk, tile of rows): W = tril(q . k^T * exp(cd_i -
//     cd_j)) * scale_j is formed once per tile of keys, then y = exp(cd) *
//     (q . S_in) + W . v. Where P fits one column tile (zamba2-7b: P 64),
//     each tile of W is used as soon as it is formed, so only that tile
//     lives in shared memory; where P spans several (xlstm-1.3b: P 1025 in
//     9 tiles of 128), W^T for all keys up to the tile's last row stays in
//     shared memory for every p-tile, and the cross term exp(cd) * (q .
//     S_in), two thirds of the products there, comes from pass 3a.
//  3a. (only where P spans several column tiles, run between 2 and 3) the
//     cross term: a (C x N) by (N x P) product per (bh, chunk), tiled as
//     pass 1, into an fp32 (fp64) scratch that pass 3 starts from.
// Every product is one register-blocked mainloop (Tile, tile_gemm): 256
// threads, a 4 x 4 or 8 x 8 output tile a thread (64 x 64 or 128 x 128 a
// block; 128 where the state is at least that wide in float32), both
// operands k-major in padded shared memory read as 16-byte loads, the next
// slice fetched into registers while this one is multiplied. The decay mask
// is a select, never a multiply by 0/1: for j > i, exp(cd_i - cd_j) may be
// inf, and inf * 0 would be NaN. Tensor cores are not used: the reference's
// products are fp32.
//
// Scratch, from the wrapper, in the accumulator type: the states, (BH, S/C
// - 1, N, P) — 16 * 7 * 512 * 1025 * 4 B = 235 MB at xlstm-1.3b's layer,
// well within the card's 80 GB — the (BH, S/C - 1) decays, and where pass 3a
// runs its (BH, S, P) cross term (134 MB there). Shared memory is set by the
// chunk and P, not by N; the wrapper asks repro_ssm_scan_smem_bytes.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing and returns the first failing launch's
// cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads

// depth of a staged slice for a tile of (16 TM) x (16 TN): four values a
// thread per operand and slice (TM = 8: 128 wide, 8 deep; TM = 4: 64, 16)
__host__ __device__ constexpr int slice_depth(int TM) { return 64 / TM; }
constexpr int kMaxSmem = 232448;   // bytes of shared memory a block may opt into

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

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// four consecutive values from 16-byte aligned shared memory
__device__ __forceinline__ void ld4(const float* p, float* r) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
}
__device__ __forceinline__ void ld4(const double* p, double* r) {
  const double2 v0 = *reinterpret_cast<const double2*>(p);
  const double2 v1 = *reinterpret_cast<const double2*>(p + 2);
  r[0] = v0.x; r[1] = v0.y; r[2] = v1.x; r[3] = v1.y;
}

// A block tile of (16 TM) x (16 TN) outputs over 16 x 16 threads; thread
// (tm, tn) holds rows (i / 4) * 64 + tm * 4 + i % 4 and columns likewise:
// groups of four, 64 apart, so that its operands are 16-byte shared loads
// and a warp's loads of one k fall on distinct banks.
__device__ __forceinline__ int tile_row(int tm, int i) { return (i / 4) * 64 + tm * 4 + i % 4; }

template <typename Acc, int TM, int TN>
struct Tile {
  Acc v[TM][TN];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) v[i][j] = 0;
    }
  }
  // v += A^T B over BK depths: A at a[k * LDA + row], B at b[k * LDB + col]
  // (both k-major in shared memory), a and b already offset by tm * 4 and
  // tn * 4
  template <int BK, int LDA, int LDB>
  __device__ __forceinline__ void mma(const Acc* a, const Acc* b) {
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      Acc av[TM], bv[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) ld4(a + k * LDA + g * 64, av + 4 * g);
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) ld4(b + k * LDB + h * 64, bv + 4 * h);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) v[i][j] += av[i] * bv[j];
      }
    }
  }
};

// Staging of one BK-deep slice of an operand into k-major shared memory
// ([k][col], row stride ld), from registers fetched one slice ahead.
//   KLoader: the source is k-major too, src[(k0 + k) * lds + c0 + c] (k rows
//            of v, of k scaled per row, of a state); optional per-k scale.
//   MLoader: the source is col-major, src[(c0 + c) * lds + k] (rows of q or
//            k, whose k is the state dimension): transposed on the way.
// Zero outside k_total x c_total. COLS is the tile's width (64 or 128).
template <typename T, typename Acc, int COLS, int BK>
struct KLoader {
  static constexpr int kItems = BK * COLS / kThreads;
  const T* src;
  size_t lds;
  int k_total, c0, c_total;
  const Acc* kscale;  // shared memory, indexed by k, or null
  Acc r[kItems];
  __device__ __forceinline__ void fetch(int k0) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = it * kThreads + threadIdx.x, kk = idx / COLS, c = idx % COLS;
      const int k = k0 + kk;
      Acc val = 0;
      if (k < k_total && c0 + c < c_total) {
        val = widen(src[(size_t)k * lds + c0 + c]);
        if (kscale != nullptr) val *= kscale[k];
      }
      r[it] = val;
    }
  }
  template <int LD>
  __device__ __forceinline__ void put(Acc* dst) const {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      dst[(idx / COLS) * LD + idx % COLS] = r[it];
    }
  }
};

template <typename T, typename Acc, int COLS, int BK>
struct MLoader {
  static constexpr int kItems = BK * COLS / kThreads;
  const T* src;
  size_t lds;
  int k_total, c0, c_total;
  Acc r[kItems];
  __device__ __forceinline__ void fetch(int k0) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = it * kThreads + threadIdx.x, c = idx / BK, kk = idx % BK;
      const int k = k0 + kk;
      r[it] = (k < k_total && c0 + c < c_total) ? Acc(widen(src[(size_t)(c0 + c) * lds + k])) : Acc(0);
    }
  }
  template <int LD>
  __device__ __forceinline__ void put(Acc* dst) const {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int idx = it * kThreads + threadIdx.x;
      dst[(idx % BK) * LD + idx / BK] = r[it];
    }
  }
};

// t += A^T B over depth K in BK slices (K rounded up: past K both operands
// are zero where they are staged, and W^T is zero where it is read in
// place). A is staged by `la` into as[2][BK][LDA] or, with la == nullptr,
// read in place at a_direct[k * LDA]; B is staged by lb into bs[2][BK][LDB].
// The next slice is fetched into registers while this one is multiplied.
// Ends with every thread past a barrier.
template <int BK, int LDA, int LDB, typename Acc, int TM, int TN, typename LA, typename LB>
__device__ __forceinline__ void tile_gemm(Tile<Acc, TM, TN>& t, LA* la, Acc* as, const Acc* a_direct, LB& lb,
                                          Acc* bs, int K) {
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  const int steps = (K + BK - 1) / BK;
  if (steps == 0) return;
  if (la) la->fetch(0);
  lb.fetch(0);
  if (la) la->template put<LDA>(as);
  lb.template put<LDB>(bs);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {
      if (la) la->fetch((s + 1) * BK);
      lb.fetch((s + 1) * BK);
    }
    const Acc* a = la ? as + buf * BK * LDA : a_direct + (size_t)s * BK * LDA;
    t.template mma<BK, LDA, LDB>(a + tm * 4, bs + buf * BK * LDB + tn * 4);
    if (s + 1 < steps) {
      if (la) la->template put<LDA>(as + (buf ^ 1) * BK * LDA);
      lb.template put<LDB>(bs + (buf ^ 1) * BK * LDB);
    }
    __syncthreads();
  }
}

// cd[0..C) = cumsum of ld[0..C): a segment per lane of warp 0, then a warp
// scan of the segment sums. Ends with __syncthreads.
template <typename Acc>
__device__ __forceinline__ void chunk_cumsum(Acc* cd, const Acc* ld, int C) {
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    const int seg = (C + 31) / 32;
    const int lo = min(C, lane * seg), hi = min(C, lo + seg);
    Acc run = 0;
    for (int i = lo; i < hi; ++i) {
      run += ld[i];
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
}

// Shared memory of each pass at tile (16 TM) x (16 TN), in accumulator
// elements. Pass 3: cd and scale (C each), W^T (its keys x the tile's rows;
// one tile of keys where it streams), two slices of q^T and two of the
// other operand.
// two slices each of A (16 TM wide) and B (16 TN wide)
constexpr size_t slices_elems(int TM, int TN) {
  return 2 * (size_t)slice_depth(TM) * (16 * TM + 4) + 2 * (size_t)slice_depth(TM) * (16 * TN + 4);
}
constexpr size_t pass1_elems(int C, int TM, int TN) { return 2 * (size_t)round_up(C, 4) + slices_elems(TM, TN); }
constexpr size_t pass3_elems(int C, int TM, int TN, bool stream) {
  return 2 * (size_t)round_up(C, 4) + (size_t)(stream ? 16 * TN : round_up(C, 16 * TN)) * (16 * TM + 4) +
         slices_elems(TM, TN);
}
constexpr size_t cross_elems(int C, int TM, int TN) { return (size_t)round_up(C, 4) + slices_elems(TM, TN); }

// ---- pass 1: dS_c = (k * gk)^T . v for chunks 0 .. nc-2, and exp(cd_last) ----
template <typename T, typename Acc, int TM, int TN>
__global__ void __launch_bounds__(kThreads, TM == 4 && sizeof(Acc) == 4 ? 3 : 2)
chunk_states(const T* __restrict__ k, const T* __restrict__ v, const Acc* __restrict__ ld,
             const Acc* __restrict__ sc, Acc* __restrict__ states, Acc* __restrict__ dec, int S, int N, int P,
             int C) {
  constexpr int BM = 16 * TM, BN = 16 * TN;  // state rows n x columns p
  constexpr int BK = slice_depth(TM);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* as = reinterpret_cast<Acc*>(smem_raw);  // [2][BK][BM + 4]
  Acc* bs = as + 2 * BK * (BM + 4);            // [2][BK][BN + 4]
  Acc* cd = bs + 2 * BK * (BN + 4);            // [C]
  Acc* gk = cd + round_up(C, 4);               // [C]
  const int nc1 = S / C - 1;
  const int tiles_n = (N + BM - 1) / BM, tiles_p = (P + BN - 1) / BN;
  const int bh = blockIdx.y;
  const int tile = blockIdx.x % (tiles_n * tiles_p), c = blockIdx.x / (tiles_n * tiles_p);
  const int n0 = (tile / tiles_p) * BM, p0 = (tile % tiles_p) * BN;
  const size_t t0 = (size_t)bh * S + (size_t)c * C;  // the chunk's first row
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;

  chunk_cumsum(cd, ld + t0, C);
  const Acc cd_last = cd[C - 1];
  for (int j = tid; j < C; j += kThreads) gk[j] = sc[t0 + j] * ex(cd_last - cd[j]);
  if (tile == 0 && tid == 0) dec[(size_t)bh * nc1 + c] = ex(cd_last);
  __syncthreads();

  Tile<Acc, TM, TN> t;
  t.zero();
  KLoader<T, Acc, BM, BK> la{k + t0 * N, (size_t)N, C, n0, N, gk};
  KLoader<T, Acc, BN, BK> lb{v + t0 * P, (size_t)P, C, p0, P, nullptr};
  tile_gemm<BK, BM + 4, BN + 4>(t, &la, as, (const Acc*)nullptr, lb, bs, C);

  Acc* out = states + ((size_t)bh * nc1 + c) * N * P;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int n = n0 + tile_row(tm, i);
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int p = p0 + tile_row(tn, j);
      if (p < P) out[(size_t)n * P + p] = t.v[i][j];
    }
  }
}

// ---- pass 2: in place, slot c <- state entering chunk c + 1 ----
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
pass_states(Acc* __restrict__ states, const Acc* __restrict__ dec, int nc1, size_t NP) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int bh = blockIdx.y;
  Acc* s = states + (size_t)bh * nc1 * NP + e;
  const Acc* d = dec + (size_t)bh * nc1;
  Acc run = 0;  // the state entering chunk 0
  for (int c = 0; c < nc1; ++c) {
    run = run * d[c] + s[(size_t)c * NP];
    s[(size_t)c * NP] = run;
  }
}

// ---- pass 3a (more than one p-tile): the cross-chunk term ----
// yx[i][p] = exp(cd_i) * (q . S_in)[i][p] for chunks 1 .. nc-1, into fp32
// (fp64) scratch: a product of (C x N) by (N x P) per (bh, chunk), tiled as
// pass 1, so that pass 3 keeps only the within-chunk term.
template <typename T, typename Acc, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
chunk_cross(const T* __restrict__ q, const Acc* __restrict__ ld, const Acc* __restrict__ states,
            Acc* __restrict__ yx, int S, int N, int P, int C) {
  constexpr int R = 16 * TM, TP = 16 * TN, LDA = R + 4, LDB = TP + 4;
  constexpr int BK = slice_depth(TM);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* as = reinterpret_cast<Acc*>(smem_raw);  // [2][BK][LDA]: q^T slices
  Acc* bs = as + 2 * BK * LDA;                 // [2][BK][LDB]: state slices
  Acc* cd = bs + 2 * BK * LDB;                 // [C]
  const int nc = S / C, rtiles = (C + R - 1) / R, ptiles = (P + TP - 1) / TP;
  const int bh = blockIdx.y, tile = blockIdx.x % (rtiles * ptiles);
  const int c = 1 + blockIdx.x / (rtiles * ptiles);
  const int i0 = (tile / ptiles) * R, p0 = (tile % ptiles) * TP;
  const size_t t0 = (size_t)bh * S + (size_t)c * C;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;

  chunk_cumsum(cd, ld + t0, C);
  Tile<Acc, TM, TN> t;
  t.zero();
  MLoader<T, Acc, R, BK> lq{q + t0 * N, (size_t)N, N, i0, C};
  KLoader<Acc, Acc, TP, BK> le{states + ((size_t)bh * (nc - 1) + c - 1) * N * P, (size_t)P, N, p0, P, nullptr};
  tile_gemm<BK, LDA, LDB>(t, &lq, as, (const Acc*)nullptr, le, bs, N);
  Acc* out = yx + t0 * P;
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = i0 + tile_row(tm, a);
    if (i >= C) continue;
    const Acc e = ex(cd[i]);
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int p = p0 + tile_row(tn, b);
      if (p < P) out[(size_t)i * P + p] = t.v[a][b] * e;
    }
  }
}

// ---- pass 3: y for a tile of 16 TM rows of one chunk ----
// STREAM (P fits one tile of 16 TN columns): the cross term is taken here,
// and W is formed and used one tile of keys at a time, so only that tile
// lives in shared memory. Otherwise W^T is formed once for all keys up to
// the tile's last row and used for every p-tile, and the cross term comes
// from pass 3a's scratch.
template <typename T, typename Acc, int TM, int TN, bool STREAM>
__global__ void __launch_bounds__(kThreads, STREAM ? (TM == 4 && sizeof(Acc) == 4 ? 3 : 2) : (TM == 4 ? 2 : 1))
chunk_outputs(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const Acc* __restrict__ ld, const Acc* __restrict__ sc, const Acc* __restrict__ states,
              const Acc* __restrict__ yx, T* __restrict__ y, int S, int N, int P, int C) {
  constexpr int R = 16 * TM, TP = 16 * TN;  // rows of the tile; keys and p-columns per step
  constexpr int LDA = R + 4, LDB = TP + 4;
  constexpr int BK = slice_depth(TM);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* as = reinterpret_cast<Acc*>(smem_raw);  // [2][BK][LDA]: q^T slices
  Acc* bs = as + 2 * BK * LDA;                 // [2][BK][LDB]: k^T, state or v slices
  Acc* wt = bs + 2 * BK * LDB;                 // [keys][LDA]: W^T (STREAM: one tile of keys)
  Acc* cd = wt + (size_t)(STREAM ? TP : round_up(C, TP)) * LDA;  // [C]
  Acc* scs = cd + round_up(C, 4);              // [C]
  const int nc = S / C, rtiles = (C + R - 1) / R;
  const int bh = blockIdx.y, c = blockIdx.x / rtiles, i0 = (blockIdx.x % rtiles) * R;
  const int J = min(C, i0 + R);                // keys 0 .. J-1 reach this tile's rows
  const size_t t0 = (size_t)bh * S + (size_t)c * C;
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  const T* qc = q + t0 * N;
  T* yc = y + t0 * P;

  for (int j = tid; j < C; j += kThreads) scs[j] = sc[t0 + j];
  chunk_cumsum(cd, ld + t0, C);

  // W^T[j][i] = (q . k^T)[i][j] * exp(cd_i - cd_j) * scale_j for j <= i, else
  // 0 (a select), for the keys j0 .. j0 + TP - 1, at row j - jbase of wt
  auto form_w = [&](int j0, int jbase) {
    Tile<Acc, TM, TN> t;
    t.zero();
    MLoader<T, Acc, R, BK> lq{qc, (size_t)N, N, i0, C};
    MLoader<T, Acc, TP, BK> lk{k + t0 * N, (size_t)N, N, j0, C};
    tile_gemm<BK, LDA, LDB>(t, &lq, as, (const Acc*)nullptr, lk, bs, N);
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int r = tile_row(tm, a), i = i0 + r;
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const int j = j0 + tile_row(tn, b);
        Acc val = 0;
        if (i < C && j <= i) val = t.v[a][b] * ex(cd[i] - cd[j]) * scs[j];
        wt[(size_t)(j - jbase) * LDA + r] = val;
      }
    }
  };
  auto store = [&](const Tile<Acc, TM, TN>& t, int p0) {
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int i = i0 + tile_row(tm, a);
      if (i >= C) continue;
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const int p = p0 + tile_row(tn, b);
        if (p < P) yc[(size_t)i * P + p] = Narrow<T, Acc>::of(t.v[a][b]);
      }
    }
  };

  if constexpr (STREAM) {
    Tile<Acc, TM, TN> acc;
    acc.zero();
    if (c > 0) {  // exp(cd) * (q . S_in); chunk 0 enters with zeros
      MLoader<T, Acc, R, BK> lq{qc, (size_t)N, N, i0, C};
      KLoader<Acc, Acc, TP, BK> le{states + ((size_t)bh * (nc - 1) + c - 1) * N * P, (size_t)P, N, 0, P,
                                   nullptr};
      tile_gemm<BK, LDA, LDB>(acc, &lq, as, (const Acc*)nullptr, le, bs, N);
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const int i = i0 + tile_row(tm, a);
        const Acc e = i < C ? ex(cd[i]) : Acc(0);
#pragma unroll
        for (int b = 0; b < TN; ++b) acc.v[a][b] *= e;
      }
    }
    for (int j0 = 0; j0 < J; j0 += TP) {
      form_w(j0, j0);  // read by the next product after its first barrier
      KLoader<T, Acc, TP, BK> lv{v + (t0 + j0) * P, (size_t)P, C - j0, 0, P, nullptr};
      tile_gemm<BK, LDA, LDB>(acc, (MLoader<T, Acc, R, BK>*)nullptr, as, wt, lv, bs, min(TP, J - j0));
    }
    store(acc, 0);
  } else {
    for (int j0 = 0; j0 < J; j0 += TP) form_w(j0, 0);  // once, for all p-tiles
    __syncthreads();
    for (int p0 = 0; p0 < P; p0 += TP) {
      Tile<Acc, TM, TN> acc;
      if (c > 0) {  // pass 3a's cross term
        const Acc* x = yx + t0 * P;
#pragma unroll
        for (int a = 0; a < TM; ++a) {
          const int i = i0 + tile_row(tm, a);
#pragma unroll
          for (int b = 0; b < TN; ++b) {
            const int p = p0 + tile_row(tn, b);
            acc.v[a][b] = (i < C && p < P) ? x[(size_t)i * P + p] : Acc(0);
          }
        }
      } else {
        acc.zero();
      }
      // + W . v over the keys up to the tile's last row (W^T is 0 past the
      // diagonal, and read where it lies)
      KLoader<T, Acc, TP, BK> lv{v + t0 * P, (size_t)P, C, p0, P, nullptr};
      tile_gemm<BK, LDA, LDB>(acc, (MLoader<T, Acc, R, BK>*)nullptr, as, wt, lv, bs, J);
      store(acc, p0);
    }
  }
}

template <typename F>
int allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// pass 3 streams W where P fits one tile of columns
__host__ __device__ constexpr bool streams_w(int P, int TN) { return P <= 16 * TN; }

// The tile: 128 x 128 (8 x 8 a thread) where the state is at least that
// large in both dimensions, float32 operands and pass 3 fits; else 64 x 64.
inline bool wide_tiles(int N, int P, int C, size_t elt) {
  return elt == sizeof(float) && N >= 128 && P >= 128 &&
         pass3_elems(C, 8, 8, streams_w(P, 8)) * elt <= (size_t)kMaxSmem;
}

// bytes of shared memory of the largest block at tile (16 TM) x (16 TN)
inline size_t smem_bytes(int P, int C, int TM, int TN, size_t elt) {
  size_t e = pass1_elems(C, TM, TN);
  const size_t e3 = pass3_elems(C, TM, TN, streams_w(P, TN)), ex_ = cross_elems(C, TM, TN);
  if (e3 > e) e = e3;
  if (!streams_w(P, TN) && ex_ > e) e = ex_;
  return e * elt;
}

template <typename T, typename Acc, int TM, int TN>
int launch_tiles(const void* q, const void* k, const void* v, const void* ld, const void* sc, void* y,
                 void* states, void* dec, void* yx, int BH, int S, int N, int P, int C, cudaStream_t stream) {
  if (smem_bytes(P, C, TM, TN, sizeof(Acc)) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool stream_w = streams_w(P, TN);
  const size_t smem1 = pass1_elems(C, TM, TN) * sizeof(Acc);
  const size_t smemx = cross_elems(C, TM, TN) * sizeof(Acc);
  const size_t smem3 = pass3_elems(C, TM, TN, stream_w) * sizeof(Acc);
  const int nc = S / C;
  const int rtiles = (C + 16 * TM - 1) / (16 * TM), ptiles = (P + 16 * TN - 1) / (16 * TN);
  const T* pq = static_cast<const T*>(q);
  const T* pk = static_cast<const T*>(k);
  const T* pv = static_cast<const T*>(v);
  const Acc* pld = static_cast<const Acc*>(ld);
  const Acc* psc = static_cast<const Acc*>(sc);
  Acc* pst = static_cast<Acc*>(states);
  Acc* pdec = static_cast<Acc*>(dec);
  Acc* pyx = static_cast<Acc*>(yx);
  int err;
  if (nc > 1) {
    const size_t tiles = (size_t)((N + 16 * TM - 1) / (16 * TM)) * ptiles * (nc - 1);
    const size_t np = (size_t)N * P;
    if (tiles > INT_MAX || (size_t)rtiles * ptiles * (nc - 1) > INT_MAX ||
        (np + kThreads - 1) / kThreads > INT_MAX) {
      return (int)cudaErrorInvalidValue;
    }
    if ((err = allow_smem(chunk_states<T, Acc, TM, TN>, smem1)) != 0) return err;
    chunk_states<T, Acc, TM, TN><<<dim3((unsigned)tiles, BH), kThreads, smem1, stream>>>(pk, pv, pld, psc, pst,
                                                                                           pdec, S, N, P, C);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    pass_states<Acc><<<dim3((unsigned)((np + kThreads - 1) / kThreads), BH), kThreads, 0, stream>>>(pst, pdec,
                                                                                                   nc - 1, np);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    if (!stream_w) {
      if ((err = allow_smem(chunk_cross<T, Acc, TM, TN>, smemx)) != 0) return err;
      chunk_cross<T, Acc, TM, TN><<<dim3(rtiles * ptiles * (nc - 1), BH), kThreads, smemx, stream>>>(
          pq, pld, pst, pyx, S, N, P, C);
      if ((err = (int)cudaGetLastError()) != 0) return err;
    }
  }
  if ((size_t)nc * rtiles > INT_MAX) return (int)cudaErrorInvalidValue;
  if (stream_w) {
    if ((err = allow_smem(chunk_outputs<T, Acc, TM, TN, true>, smem3)) != 0) return err;
    chunk_outputs<T, Acc, TM, TN, true><<<dim3(nc * rtiles, BH), kThreads, smem3, stream>>>(
        pq, pk, pv, pld, psc, pst, pyx, static_cast<T*>(y), S, N, P, C);
  } else {
    if ((err = allow_smem(chunk_outputs<T, Acc, TM, TN, false>, smem3)) != 0) return err;
    chunk_outputs<T, Acc, TM, TN, false><<<dim3(nc * rtiles, BH), kThreads, smem3, stream>>>(
        pq, pk, pv, pld, psc, pst, pyx, static_cast<T*>(y), S, N, P, C);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename Acc>
int launch(const void* q, const void* k, const void* v, const void* ld, const void* sc, void* y, void* states,
           void* dec, void* yx, int BH, int S, int N, int P, int C, cudaStream_t stream) {
  if constexpr (sizeof(Acc) == sizeof(float)) {  // float64 takes 64 x 64 tiles only
    if (wide_tiles(N, P, C, sizeof(Acc))) {
      return launch_tiles<T, Acc, 8, 8>(q, k, v, ld, sc, y, states, dec, yx, BH, S, N, P, C, stream);
    }
  }
  return launch_tiles<T, Acc, 4, 4>(q, k, v, ld, sc, y, states, dec, yx, BH, S, N, P, C, stream);
}

inline int tile_tm(int N, int P, int C, int dtype) {
  return wide_tiles(N, P, C, dtype == 3 ? sizeof(double) : sizeof(float)) ? 8 : 4;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 float64 — of q, k, v and
// y, all contiguous. log_decay and scale are float32 (float64 for float64
// operands). S % C == 0; 1 <= BH <= 65535. Scratch of the accumulator type:
// states (BH, S/C - 1, N, P) and dec (BH, S/C - 1), unused when S == C; yx
// (BH, S, P) where repro_ssm_scan_cross_scratch says so, else unused.
extern "C" int repro_ssm_scan(const void* q, const void* k, const void* v, const void* ld, const void* sc, void* y,
                              void* states, void* dec, void* yx, int BH, int S, int N, int P, int C, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH < 1 || BH > 65535 || S < 1 || N < 1 || P < 1 || C < 1 || S % C != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float, float>(q, k, v, ld, sc, y, states, dec, yx, BH, S, N, P, C, s);
    case 1: return launch<__nv_bfloat16, float>(q, k, v, ld, sc, y, states, dec, yx, BH, S, N, P, C, s);
    case 2: return launch<__half, float>(q, k, v, ld, sc, y, states, dec, yx, BH, S, N, P, C, s);
    case 3: return launch<double, double>(q, k, v, ld, sc, y, states, dec, yx, BH, S, N, P, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Bytes of shared memory the largest block of repro_ssm_scan takes at state
// rows N, columns P and chunk C for operands of `dtype`, and the most a block
// may opt into: the wrapper raises where the first exceeds the second (a size
// past INT_MAX reads as INT_MAX). The chunk sets it: W^T holds the chunk's
// keys for a tile of rows (one tile of keys where P fits one tile of
// columns); the state is staged in slices.
extern "C" int repro_ssm_scan_smem_bytes(int N, int P, int C, int dtype) {
  if (N < 1 || P < 1 || C < 1 || dtype < 0 || dtype > 3) return -1;
  const int tm = tile_tm(N, P, C, dtype);
  const size_t bytes = smem_bytes(P, C, tm, tm, dtype == 3 ? sizeof(double) : sizeof(float));
  return bytes > (size_t)INT_MAX ? INT_MAX : (int)bytes;
}

// 1 where repro_ssm_scan takes the cross-chunk term in a pass of its own and
// needs the yx scratch: P spans more than one tile of columns
extern "C" int repro_ssm_scan_cross_scratch(int N, int P, int C, int dtype) {
  return streams_w(P, tile_tm(N, P, C, dtype)) ? 0 : 1;
}

extern "C" int repro_ssm_scan_smem_limit() { return kMaxSmem; }
