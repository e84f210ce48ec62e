// AXPY: out = alpha * x + y over (n,), in x's dtype (float32, bfloat16,
// float16 or float64) — the paper's DAXPY.
//
// Replaces: repro/kernels/axpy.py::_axpy_kernel (wrapper `axpy`). There one
// VMEM strip of `block` elements per grid step lets the Pallas pipeline
// overlap the next strip's loads with this strip's FMAs. Here `block` and
// `lmul` are the wrapper's contract only: blocks run in no order, and the
// kernel is one grid-stride loop over 16-byte vectors.
//
// What bounds it on an H100: two loads and one store per multiply-add
// (1/12 operation per byte in float32), so the time to move 3n elements
// through device memory, far left of the card's ridge; the arithmetic is
// free.
//
// What the design does about it:
//  - every thread moves 16 bytes per load and per store (4 f32, 8 bf16/f16,
//    2 f64), neighbouring threads on neighbouring addresses, and issues the
//    loads of kU vectors of x and of y before it uses the first: enough
//    bytes in flight per SM to approach the memory rate;
//  - a grid-stride loop over vectors with a fixed grid, then the ragged
//    tail element by element; where a base address is not 16-byte aligned
//    the whole array goes element by element.
//
// Rounding: where the reference rounds. `alpha` arrives already rounded to
// x's dtype (the wrapper does that, as jnp.asarray(alpha, x.dtype) does).
// The product is rounded to x's dtype, then the sum is rounded to x's
// dtype: two roundings, no fused multiply-add (__fmul_rn/__fadd_rn keep the
// compiler from contracting them). bf16/f16 operands are widened to float,
// where their product is exact, and each result is rounded back to the
// narrow type — what PyTorch's own elementwise multiply and add do, so the
// kernel and the plain version agree bit for bit.
//
// C interface (loaded with ctypes): launches on the given stream, does not
// synchronise, allocates nothing and returns the launch's cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kU = 4;             // vectors of x and of y loaded ahead per thread
constexpr int kMaxBlocks = 4096;  // grid cap; the loop strides over the rest

// one rounding per operation, in the element type
__device__ __forceinline__ float axpy1(float a, float x, float y) {
  return __fadd_rn(__fmul_rn(a, x), y);
}
__device__ __forceinline__ double axpy1(double a, double x, double y) {
  return __dadd_rn(__dmul_rn(a, x), y);
}
__device__ __forceinline__ __nv_bfloat16 axpy1(__nv_bfloat16 a, __nv_bfloat16 x, __nv_bfloat16 y) {
  const __nv_bfloat16 p = __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(x)));
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(p), __bfloat162float(y)));
}
__device__ __forceinline__ __half axpy1(__half a, __half x, __half y) {
  const __half p = __float2half_rn(__fmul_rn(__half2float(a), __half2float(x)));
  return __float2half_rn(__fadd_rn(__half2float(p), __half2float(y)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
axpy_kernel(T alpha, const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, int64_t n,
            int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t done = 0;  // elements covered by the vector loop
  if (vec_ok) {
    const int64_t nvec = n / VEC;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* yv = reinterpret_cast<const uint4*>(y);
    uint4* ov = reinterpret_cast<uint4*>(out);
    int64_t i = tid;
    // kU vectors per thread per trip, all loads issued before the first use
    for (; i + (kU - 1) * stride < nvec; i += kU * stride) {
      uint4 rx[kU], ry[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        rx[u] = __ldg(xv + i + u * stride);
        ry[u] = __ldg(yv + i + u * stride);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        uint4 ro;
        const T* ex = reinterpret_cast<const T*>(&rx[u]);
        const T* ey = reinterpret_cast<const T*>(&ry[u]);
        T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
        for (int c = 0; c < VEC; ++c) eo[c] = axpy1(alpha, ex[c], ey[c]);
        ov[i + u * stride] = ro;
      }
    }
    for (; i < nvec; i += stride) {
      const uint4 rx = __ldg(xv + i), ry = __ldg(yv + i);
      uint4 ro;
      const T* ex = reinterpret_cast<const T*>(&rx);
      const T* ey = reinterpret_cast<const T*>(&ry);
      T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int c = 0; c < VEC; ++c) eo[c] = axpy1(alpha, ex[c], ey[c]);
      ov[i] = ro;
    }
    done = nvec * VEC;
  }
  // the ragged tail, or everything where 16-byte vectors do not fit
  for (int64_t i = done + tid; i < n; i += stride) out[i] = axpy1(alpha, x[i], y[i]);
}

template <typename T>
int launch(T alpha, const void* x, const void* y, void* out, int64_t n, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec_ok = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int64_t work = vec_ok ? (n / VEC + n % VEC) : n;  // loop trips of the widest pass
  int64_t blocks = (work + (int64_t)kThreads * kU - 1) / ((int64_t)kThreads * kU);
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  axpy_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(alpha, static_cast<const T*>(x),
                                                            static_cast<const T*>(y), static_cast<T*>(out), n,
                                                            vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16, 3 float64. x, y, out (n,)
// contiguous, one dtype. `alpha` is already rounded to that dtype, so the
// conversion from double here is exact.
extern "C" int repro_axpy(double alpha, const void* x, const void* y, void* out, int64_t n, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>((float)alpha, x, y, out, n, s);
    case 1: return launch<__nv_bfloat16>(__float2bfloat16_rn((float)alpha), x, y, out, n, s);
    case 2: return launch<__half>(__float2half_rn((float)alpha), x, y, out, n, s);
    case 3: return launch<double>(alpha, x, y, out, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
