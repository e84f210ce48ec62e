// Direct 2-D convolution, VALID, stride 1 — the paper's DCONV (GoogLeNet
// layer 1): x (C,H,W) pre-padded, w (OC,C,KH,KW) -> out (OC,H-KH+1,W-KW+1).
// Operands float32, bfloat16 or float16 accumulate in float32; float64
// operands accumulate in float64. The result is rounded once, to out's
// dtype.
//
// Replaces: repro/kernels/conv.py::_conv_kernel (wrapper `conv2d_direct`).
// There one grid step computes one output row of one output channel as
// C*KH*KW shifted FMAs over rows of the whole image held in VMEM: Ara's
// vector-slide form, one output row per vector register. Here the slide
// happens in registers. No im2col.
//
// What bounds it on an H100 at GoogLeNet layer 1 (x (3,118,118), w
// (64,3,7,7)): 2.4e8 operations against 3.4 MB moved, so operations on the
// CUDA cores — 3.5 us at the card's 67 TFLOP/s float32 FMA rate. This
// kernel multiplies and adds separately (see below), two instructions a
// tap, so its own floor is twice that, 7.0 us.
//
// What the design does about it (the compile-time-taps route, KH x KW 7x7
// and 3x3, conv_taps_kernel):
//  - A block owns kTapRows output rows x a group of kOcGroup output
//    channels. The rows + KH - 1 input rows of every channel they need are
//    staged in shared memory once for the group, widened, rows padded so
//    that every window below is whole 16-byte words; so are the group's
//    kOcGroup * C * KH * KW weights, output channels fastest.
//  - A thread owns a register tile of kColsThread adjacent output columns
//    x kOcThread output channels. For each (c, kr) it loads its input
//    window (kColsThread + KW - 1 values) into registers once, in 16-byte
//    words, and slides it over the KW taps; the kOcThread weights of a tap
//    are one 16-byte read that the lanes of a warp share (a broadcast), so
//    each weight read serves kColsThread multiplies and each input read
//    KW * kOcThread.
//  - KH and KW are template parameters: the tap loops unroll fully and the
//    window and tile indices are constants, so the window stays in
//    registers.
//  - Tile sizes: 4 rows x 16 channels a block, 4 columns x 4 channels a
//    thread. Of the tiles timed in turns (tools/torch_kernel_variants.py
//    --conv), they tie the best at layer 1 (112 blocks of 256 threads) and
//    are the fastest at GoogLeNet's 3x3 layer (64 channels), where a
//    larger channel group halves the blocks that stage the same rows.
// Any other tap shape takes the general route (conv_kernel, the first
// version): runtime tap loops, one output per thread per pass, two
// shared-memory reads per multiply. So does a 7x7 or 3x3 shape whose
// channels do not fit the taps route's shared memory at one output row
// (its rows are padded and it holds kOcGroup channels' weights, the general
// route one channel's): many channels on a wide image, or in float64.
//
// Both routes sum each output's taps in the reference's order, c -> kr ->
// t, one multiply and one add per tap, each rounded (__fmul_rn/__fadd_rn:
// no contraction into an FMA), which is what the plain version's tensor
// arithmetic does: the result is bit-equal to it.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing and returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;                 // output rows per block (general route)
constexpr int kSmemBudget = 200 * 1024;     // bytes of shared memory a block may take
// the compile-time-taps route
constexpr int kTapRows = 4;                 // output rows per block
constexpr int kOcGroup = 16;                // output channels per block
constexpr int kOcThread = 4;                // ... per thread
constexpr int kColsThread = 4;              // adjacent output columns per thread
static_assert(kOcGroup % kOcThread == 0, "a thread's channels tile the group");
static_assert(kOcThread % 4 == 0 && kColsThread % 4 == 0,
              "weights and windows are read in 16-byte words (4 floats, 2 doubles)");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

// the accumulator rounded once to the output type
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

__device__ __forceinline__ float mul_add(float acc, float a, float b) { return __fadd_rn(acc, __fmul_rn(a, b)); }
__device__ __forceinline__ double mul_add(double acc, double a, double b) { return __dadd_rn(acc, __dmul_rn(a, b)); }

template <typename T, typename Acc, typename TOut>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w, TOut* __restrict__ out, int C, int H, int W, int KH,
            int KW, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h_out = H - KH + 1, w_out = W - KW + 1;
  const int in_rows = rows + KH - 1;
  Acc* xs = reinterpret_cast<Acc*>(smem_raw);  // [C][in_rows][W]
  Acc* ws = xs + (size_t)C * in_rows * W;      // [C][KH][KW]

  const int oc = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nrows = min(rows, h_out - r0);     // output rows of this block
  const int nin = nrows + KH - 1;              // input rows they need

  for (int i = threadIdx.x; i < C * nin * W; i += kThreads) {
    const int c = i / (nin * W), rem = i % (nin * W);
    const int rr = rem / W, col = rem % W;
    xs[((size_t)c * in_rows + rr) * W + col] = widen(x[((size_t)c * H + r0 + rr) * W + col]);
  }
  const int taps = C * KH * KW;
  for (int i = threadIdx.x; i < taps; i += kThreads) ws[i] = widen(w[(size_t)oc * taps + i]);
  __syncthreads();

  for (int o = threadIdx.x; o < nrows * w_out; o += kThreads) {
    const int rr = o / w_out, col = o % w_out;
    Acc acc = 0;
    for (int c = 0; c < C; ++c) {
      for (int kr = 0; kr < KH; ++kr) {
        const Acc* xrow = xs + ((size_t)c * in_rows + rr + kr) * W + col;
        const Acc* wrow = ws + (c * KH + kr) * KW;
        for (int t = 0; t < KW; ++t) acc = mul_add(acc, wrow[t], xrow[t]);
      }
    }
    out[((size_t)oc * h_out + r0 + rr) * w_out + col] = Narrow<TOut, Acc>::of(acc);
  }
}

// 16 bytes of accumulator values
template <typename Acc> struct Word16;
template <> struct Word16<float> {
  using type = float4;
  static __device__ __forceinline__ void unpack(float* dst, float4 v) {
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
};
template <> struct Word16<double> {
  using type = double2;
  static __device__ __forceinline__ void unpack(double* dst, double2 v) { dst[0] = v.x; dst[1] = v.y; }
};

// the compile-time-taps route: which tap shapes take it
constexpr bool fixed_taps(int KH, int KW) { return (KH == 7 && KW == 7) || (KH == 3 && KW == 3); }

// the staged row stride of the compile-time-taps route (Acc values): the
// last column group's window, read in whole 16-byte words, stays inside
// the row; never less than W
inline int taps_ld(int w_out, int KW, size_t acc_bytes) {
  const int ve = (int)(16 / acc_bytes);
  const int words = (kColsThread + KW - 1 + ve - 1) / ve;
  const int groups = (w_out + kColsThread - 1) / kColsThread;
  return (groups - 1) * kColsThread + words * ve;
}

// block of kTapRows output rows x kOcGroup output channels; a thread per
// (column group, row, channel subgroup) item, columns fastest
template <int KH, int KW, typename T, typename Acc, typename TOut>
__global__ void __launch_bounds__(kThreads)
conv_taps_kernel(const T* __restrict__ x, const T* __restrict__ w, TOut* __restrict__ out, int C, int H, int W,
                 int OC, int rows, int ld) {
  using Word = typename Word16<Acc>::type;
  constexpr int VE = 16 / sizeof(Acc);                  // values a 16-byte word
  constexpr int WIN = kColsThread + KW - 1;             // the window a thread slides
  constexpr int NW = (WIN + VE - 1) / VE;               // ... in 16-byte words
  constexpr int TAPS = KH * KW;
  constexpr int NSUB = kOcGroup / kOcThread;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h_out = H - KH + 1, w_out = W - KW + 1;
  const int in_rows = rows + KH - 1;
  Acc* xs = reinterpret_cast<Acc*>(smem_raw);           // [C][in_rows][ld]
  Acc* ws = xs + (size_t)C * in_rows * ld;              // [C][KH][KW][kOcGroup]

  const int r0 = blockIdx.x * rows;
  const int oc0 = blockIdx.y * kOcGroup;
  const int nrows = min(rows, h_out - r0);              // output rows of this block
  const int nin = nrows + KH - 1;                       // input rows they need

  for (int i = threadIdx.x; i < C * nin * ld; i += blockDim.x) {
    const int c = i / (nin * ld), rem = i % (nin * ld);
    const int rr = rem / ld, col = rem % ld;
    xs[((size_t)c * in_rows + rr) * ld + col] =
        col < W ? widen(x[((size_t)c * H + r0 + rr) * W + col]) : Acc(0);
  }
  for (int i = threadIdx.x; i < C * TAPS * kOcGroup; i += blockDim.x) {
    const int o = i % kOcGroup, tap = i / kOcGroup;     // tap = (c * KH + kr) * KW + t
    ws[i] = oc0 + o < OC ? widen(w[(size_t)(oc0 + o) * C * TAPS + tap]) : Acc(0);
  }
  __syncthreads();

  const int groups = (w_out + kColsThread - 1) / kColsThread;
  for (int it = threadIdx.x; it < groups * nrows * NSUB; it += blockDim.x) {
    const int cg = it % groups, rest = it / groups;
    const int rr = rest % nrows, sub = rest / nrows;
    const int col0 = cg * kColsThread;
    Acc acc[kOcThread][kColsThread];
#pragma unroll
    for (int o = 0; o < kOcThread; ++o) {
#pragma unroll
      for (int j = 0; j < kColsThread; ++j) acc[o][j] = Acc(0);
    }
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int kr = 0; kr < KH; ++kr) {
        Acc win[NW * VE];
        const Word* xw = reinterpret_cast<const Word*>(xs + ((size_t)c * in_rows + rr + kr) * ld + col0);
#pragma unroll
        for (int i = 0; i < NW; ++i) Word16<Acc>::unpack(win + i * VE, xw[i]);
        const Acc* wt = ws + (size_t)(c * KH + kr) * KW * kOcGroup + sub * kOcThread;
#pragma unroll
        for (int t = 0; t < KW; ++t) {
          Acc wv[kOcThread];
#pragma unroll
          for (int i = 0; i < kOcThread / VE; ++i)
            Word16<Acc>::unpack(wv + i * VE, reinterpret_cast<const Word*>(wt + t * kOcGroup)[i]);
#pragma unroll
          for (int o = 0; o < kOcThread; ++o) {
#pragma unroll
            for (int j = 0; j < kColsThread; ++j) acc[o][j] = mul_add(acc[o][j], wv[o], win[j + t]);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kOcThread; ++o) {
      const int oc = oc0 + sub * kOcThread + o;
      if (oc >= OC) continue;
      TOut* orow = out + ((size_t)oc * h_out + r0 + rr) * w_out;
#pragma unroll
      for (int j = 0; j < kColsThread; ++j) {
        if (col0 + j < w_out) orow[col0 + j] = Narrow<TOut, Acc>::of(acc[o][j]);
      }
    }
  }
}

// shared-memory bytes of a block at `rows` output rows, by route
inline size_t smem_bytes(bool taps, int C, int W, int KH, int KW, int rows, size_t acc_bytes) {
  if (taps) {
    const size_t ld = taps_ld(W - KW + 1, KW, acc_bytes);
    return ((size_t)C * (rows + KH - 1) * ld + (size_t)C * KH * KW * kOcGroup) * acc_bytes;
  }
  return ((size_t)C * (rows + KH - 1) * W + (size_t)C * KH * KW) * acc_bytes;
}

// the route launch() takes: the compile-time-taps kernel for its tap shapes
// where one output row of it (the group's weights, kOcGroup times the
// general route's) fits the budget, else the general kernel
inline bool taps_route(int C, int W, int KH, int KW, size_t acc_bytes) {
  return fixed_taps(KH, KW) && smem_bytes(true, C, W, KH, KW, 1, acc_bytes) <= (size_t)kSmemBudget;
}

// output rows per block on the route taps_route() picks: as many as the
// route's kTapRows (kMaxRows) and the shared-memory budget allow; 0 when
// not even one row fits
inline int rows_per_block(int C, int W, int KH, int KW, int h_out, size_t acc_bytes) {
  const bool taps = taps_route(C, W, KH, KW, acc_bytes);
  const int most = taps ? kTapRows : kMaxRows;
  for (int r = most < h_out ? most : h_out; r >= 1; --r) {
    if (smem_bytes(taps, C, W, KH, KW, r, acc_bytes) <= (size_t)kSmemBudget) return r;
  }
  return 0;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int KH, int KW, typename T, typename Acc, typename TOut>
int launch_taps(const T* x, const T* w, TOut* out, int C, int H, int W, int OC, int rows, cudaStream_t stream) {
  const int h_out = H - KH + 1, w_out = W - KW + 1;
  const size_t smem = smem_bytes(true, C, W, KH, KW, rows, sizeof(Acc));
  auto kernel = conv_taps_kernel<KH, KW, T, Acc, TOut>;
  if (int e = allow_smem(kernel, smem)) return e;
  // as many threads as the block has items, in whole warps
  const int items = ((w_out + kColsThread - 1) / kColsThread) * rows * (kOcGroup / kOcThread);
  const int threads = items < kThreads ? (items + 31) / 32 * 32 : kThreads;
  const dim3 grid((h_out + rows - 1) / rows, (OC + kOcGroup - 1) / kOcGroup);
  kernel<<<grid, threads, smem, stream>>>(x, w, out, C, H, W, OC, rows, taps_ld(w_out, KW, sizeof(Acc)));
  return (int)cudaGetLastError();
}

template <typename T, typename Acc, typename TOut>
int launch(const void* x_, const void* w_, void* out_, int C, int H, int W, int OC, int KH, int KW,
           cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  const T* w = static_cast<const T*>(w_);
  TOut* out = static_cast<TOut*>(out_);
  const int h_out = H - KH + 1;
  const int rows = rows_per_block(C, W, KH, KW, h_out, sizeof(Acc));
  if (rows < 1) return (int)cudaErrorInvalidValue;
  if (taps_route(C, W, KH, KW, sizeof(Acc))) {
    if (KH == 7) return launch_taps<7, 7, T, Acc, TOut>(x, w, out, C, H, W, OC, rows, stream);
    return launch_taps<3, 3, T, Acc, TOut>(x, w, out, C, H, W, OC, rows, stream);
  }
  const size_t smem = smem_bytes(false, C, W, KH, KW, rows, sizeof(Acc));
  auto kernel = conv_kernel<T, Acc, TOut>;
  if (int e = allow_smem(kernel, smem)) return e;
  const dim3 grid((h_out + rows - 1) / rows, OC);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, out, C, H, W, KH, KW, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_out(const void* x, const void* w, void* out, int C, int H, int W, int OC, int KH, int KW, int out_dtype,
               cudaStream_t s) {
  switch (out_dtype) {
    case 0: return launch<T, float, float>(x, w, out, C, H, W, OC, KH, KW, s);
    case 1: return launch<T, float, __nv_bfloat16>(x, w, out, C, H, W, OC, KH, KW, s);
    case 2: return launch<T, float, __half>(x, w, out, C, H, W, OC, KH, KW, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 float64. x (C,H,W), w
// (OC,C,KH,KW) of one dtype, out (OC,H-KH+1,W-KW+1), all contiguous.
// float64 operands take a float64 output only.
extern "C" int repro_conv2d(const void* x, const void* w, void* out, int C, int H, int W, int OC, int KH, int KW,
                            int dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || OC < 1 || KH < 1 || KW < 1 || H < KH || W < KW) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_out<float>(x, w, out, C, H, W, OC, KH, KW, out_dtype, s);
    case 1: return launch_out<__nv_bfloat16>(x, w, out, C, H, W, OC, KH, KW, out_dtype, s);
    case 2: return launch_out<__half>(x, w, out, C, H, W, OC, KH, KW, out_dtype, s);
    case 3:
      if (out_dtype != 3) return (int)cudaErrorInvalidValue;
      return launch<double, double, double>(x, w, out, C, H, W, OC, KH, KW, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Output rows one block of repro_conv2d computes at this shape for operands
// of `dtype`, as launch() picks them: 0 when not even one row of every
// channel fits the shared-memory budget (the wrapper raises there).
extern "C" int repro_conv2d_rows(int C, int H, int W, int KH, int KW, int dtype) {
  if (C < 1 || KH < 1 || KW < 1 || H < KH || W < KW) return 0;
  return rows_per_block(C, W, KH, KW, H - KH + 1, dtype == 3 ? sizeof(double) : sizeof(float));
}

extern "C" int repro_conv2d_smem_budget() { return kSmemBudget; }

// The route repro_conv2d takes at this shape for operands of `dtype`, as
// launch() picks it: 1 the compile-time-taps kernel, 0 the general one
// (runtime taps; repro_conv2d_rows says whether it fits).
extern "C" int repro_conv2d_route(int C, int H, int W, int KH, int KW, int dtype) {
  if (C < 1 || KH < 1 || KW < 1 || H < KH || W < KW) return 0;
  return taps_route(C, W, KH, KW, dtype == 3 ? sizeof(double) : sizeof(float)) ? 1 : 0;
}
