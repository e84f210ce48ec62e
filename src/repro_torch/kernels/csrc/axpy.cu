// AXPY: out = alpha * x + y over (n,), in x's dtype (float32, bfloat16,
// float16 or float64) — the paper's DAXPY.
//
// Replaces: repro/kernels/axpy.py::_axpy_kernel (wrapper `axpy`). There one
// VMEM strip of `block` elements per grid step lets the Pallas pipeline
// overlap the next strip's loads with this strip's FMAs. Here `block` and
// `lmul` are the wrapper's contract only: each CUDA block takes its own
// fixed, contiguous piece of the vectors in one pass.
//
// What bounds it on an H100: two loads and one store per multiply-add
// (1/12 operation per byte in float32), so the time to move 3n elements
// through device memory, far left of the card's ridge; the arithmetic is
// free. At the paper's large size (2^26 elements, 768 MB in float32) the
// stream is 15 times the L2 and nothing is read twice; at 2^20 (12 MB) the
// three arrays fit the 50 MB L2.
//
// What the design does about it:
//  - one pass, no grid-stride loop: block b takes the kThreads * kU vectors
//    from b * kThreads * kU, so the grid is as many blocks as the vectors
//    need, and the card's scheduler keeps every SM full to the end with no
//    tail of a fixed grid's last trip;
//  - one vector of x and of y a thread (kU), its width picked by size
//    (`launch`): past half the L2, 8 bytes (kStreamVecBytes), the most
//    threads, and so the most loads, in flight for the bytes; measured
//    against 16-byte vectors, several vectors a thread, streaming cache
//    hints and Hopper's 1-D bulk copies through shared memory
//    (tools/torch_kernel_variants.py --axpy), it is the one that keeps
//    pace with torch.add at 2^26. Where the three arrays fit half the L2,
//    16 bytes (kResidentVecBytes): fewer, wider requests are faster there;
//  - plain loads and stores; the ragged tail (n % vector) element by
//    element in block 0; where a base address is not aligned to the
//    vector, every element on its own.
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

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kU = 1;                  // vectors of x and of y a thread loads before it uses the first
constexpr int kStreamVecBytes = 8;     // bytes of a vector past half the L2 (16 or 8)
constexpr int kResidentVecBytes = 16;  // ... where the three arrays fit half the L2

template <int VB>
using VecOf = std::conditional_t<VB == 16, uint4, uint2>;

// plain ld.global / st.global: the streaming hints (ld.global.cs,
// .nc.L1::no_allocate, st.global.cs) measured no faster
template <typename V>
__device__ __forceinline__ V load_vec(const V* p) {
  return *p;
}

template <typename V>
__device__ __forceinline__ void store_vec(V* p, const V& v) {
  *p = v;
}

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

template <typename T, typename V>
__device__ __forceinline__ V axpy_vec(T alpha, const V& rx, const V& ry) {
  constexpr int VEC = sizeof(V) / sizeof(T);
  V ro;
  const T* ex = reinterpret_cast<const T*>(&rx);
  const T* ey = reinterpret_cast<const T*>(&ry);
  T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
  for (int c = 0; c < VEC; ++c) eo[c] = axpy1(alpha, ex[c], ey[c]);
  return ro;
}

// kU vectors of VB bytes a thread; vec_ok: all three bases aligned to VB
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads)
axpy_kernel(T alpha, const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out, int64_t n,
            int vec_ok) {
  using V = VecOf<VB>;
  constexpr int VEC = VB / sizeof(T);
  static_assert(VEC >= 1, "a vector holds at least one element");
  const int64_t first = (int64_t)blockIdx.x * kThreads * kU + threadIdx.x;
  if (vec_ok) {
    const int64_t nvec = n / VEC;
    const V* xv = reinterpret_cast<const V*>(x);
    const V* yv = reinterpret_cast<const V*>(y);
    V* ov = reinterpret_cast<V*>(out);
    V rx[kU], ry[kU];
    if ((int64_t)(blockIdx.x + 1) * kThreads * kU <= nvec) {  // a whole block: no bounds
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        rx[u] = load_vec(xv + first + u * kThreads);
        ry[u] = load_vec(yv + first + u * kThreads);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) store_vec(ov + first + u * kThreads, axpy_vec(alpha, rx[u], ry[u]));
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int64_t i = first + u * kThreads;
        if (i < nvec) {
          rx[u] = load_vec(xv + i);
          ry[u] = load_vec(yv + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int64_t i = first + u * kThreads;
        if (i < nvec) store_vec(ov + i, axpy_vec(alpha, rx[u], ry[u]));
      }
    }
    // the ragged tail: fewer than VEC elements
    const int64_t e = nvec * VEC + threadIdx.x;
    if (blockIdx.x == 0 && e < n) out[e] = axpy1(alpha, x[e], y[e]);
  } else {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t i = first + u * kThreads;
      if (i < n) out[i] = axpy1(alpha, x[i], y[i]);
    }
  }
}

// the current device's L2 bytes (asked once per device; 50 MB, an H100's,
// where the device cannot be asked)
inline int64_t l2_bytes() {
  static int64_t bytes[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 50LL << 20;
  if (bytes[dev] == 0) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrL2CacheSize, dev) != cudaSuccess || v < 1) v = 50 << 20;
    bytes[dev] = v;
  }
  return bytes[dev];
}

template <typename T, int VB>
int launch_shape(T alpha, const void* x, const void* y, void* out, int64_t n, cudaStream_t stream) {
  constexpr int VEC = VB / sizeof(T);
  const int vec_ok = (reinterpret_cast<uintptr_t>(x) % VB == 0) && (reinterpret_cast<uintptr_t>(y) % VB == 0) &&
                     (reinterpret_cast<uintptr_t>(out) % VB == 0);
  const int64_t work = vec_ok ? n / VEC : n;  // vectors, or elements
  int64_t blocks = (work + (int64_t)kThreads * kU - 1) / ((int64_t)kThreads * kU);
  if (blocks < 1) blocks = 1;  // n < VEC: block 0 takes the tail
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  axpy_kernel<T, VB><<<(unsigned)blocks, kThreads, 0, stream>>>(
      alpha, static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), n, vec_ok);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(T alpha, const void* x, const void* y, void* out, int64_t n, cudaStream_t stream) {
  if (3 * n * (int64_t)sizeof(T) > l2_bytes() / 2) {
    return launch_shape<T, kStreamVecBytes>(alpha, x, y, out, n, stream);
  }
  return launch_shape<T, kResidentVecBytes>(alpha, x, y, out, n, stream);
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
