// Direct 2-D convolution, VALID, stride 1 — the paper's DCONV (GoogLeNet
// layer 1): x (C,H,W) pre-padded, w (OC,C,KH,KW) -> out (OC,H-KH+1,W-KW+1).
// Operands float32, bfloat16 or float16 accumulate in float32; float64
// operands accumulate in float64. The result is rounded once, to out's
// dtype.
//
// Replaces: repro/kernels/conv.py::_conv_kernel (wrapper `conv2d_direct`).
// There one grid step computes one output row of one output channel as
// C*KH*KW shifted FMAs over rows of the whole image held in VMEM. Here a
// block computes up to kMaxRows (8) output rows of one output channel; the
// rows+KH-1 input rows of every channel those rows need are staged in shared memory
// once, already widened, and so are the channel's C*KH*KW weights. No
// im2col.
//
// What bounds it on an H100 at GoogLeNet layer 1 (x (3,118,118), w
// (64,3,7,7)): 2.4e8 operations against 3.4 MB moved, so operations on the
// CUDA cores — about 3.5 us at the card's 67 TFLOP/s float32 rate. This
// first version takes about 19 times that: the tap loops have runtime
// bounds, and every FMA reads two words of shared memory.
//
// What the design does about it: threads map to output elements of the
// block's rows, columns fastest, so neighbouring threads read neighbouring
// shared-memory words; every weight is a broadcast read. Each output sums
// its taps in the reference's order, c -> kr -> t, one multiply and one add
// per tap, each rounded (__fmul_rn/__fadd_rn: no contraction into an FMA),
// which is what the plain version's tensor arithmetic does.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing and returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;                 // output rows per block
constexpr int kSmemBudget = 200 * 1024;     // bytes of shared memory a block may take

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

// output rows per block: as many as kMaxRows and the shared-memory budget
// allow; 0 when not even one row fits
inline int rows_per_block(int C, int W, int KH, int KW, int h_out, size_t acc_bytes) {
  const size_t taps = (size_t)C * KH * KW;
  for (int r = kMaxRows < h_out ? kMaxRows : h_out; r >= 1; --r) {
    if (((size_t)C * (r + KH - 1) * W + taps) * acc_bytes <= (size_t)kSmemBudget) return r;
  }
  return 0;
}

template <typename T, typename Acc, typename TOut>
int launch(const void* x, const void* w, void* out, int C, int H, int W, int OC, int KH, int KW,
           cudaStream_t stream) {
  const int h_out = H - KH + 1;
  const int rows = rows_per_block(C, W, KH, KW, h_out, sizeof(Acc));
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)C * (rows + KH - 1) * W + (size_t)C * KH * KW) * sizeof(Acc);
  auto kernel = conv_kernel<T, Acc, TOut>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((h_out + rows - 1) / rows, OC);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                           static_cast<TOut*>(out), C, H, W, KH, KW, rows);
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
