// Fixed-point Taylor activation for Hopper (sm_90a) — the paper's C2.
//
// Replaces repro/kernels/taylor_activation.py::taylor_activation_pallas and
// computes the same int32 codes bit for bit.  For every element:
//
//   x   = clip(x, -(2^14 - 1), 2^14 - 1)
//   acc = c[n-1]
//   acc = rounding_rshift(acc * x, x_frac) + c[k]     k = n-2 .. 0
//
// with int32 wraparound and the rounding shift of kernels/ref.py
// (ties away from zero; x_frac <= 0 shifts nothing, as the plain version
// and the reference's oracle do).  The clamp is this kernel's contract; the
// MLP kernel's sigmoid arm clamps to ±2^14 and is a different function.
//
// What bounds it on this card.  Each element is read once and written once
// (8 bytes) and costs about 4 int32 operations per Horner step, so at the
// orders the paper uses (1–7) the kernel is bound by HBM bandwidth: 8 B per
// element over 3.35 TB/s.  The TPU kernel fused the chain to read the tile
// once; here the same fusion is the whole design.
//
// Design.  A grid-stride loop over the flat tensor.  Each thread takes four
// elements per step with one 16-byte load and one 16-byte store when both
// pointers are 16-byte aligned; the tail (and an unaligned tensor) goes
// element by element.  The constants are a device int32 array (pointer and
// count), read once per four elements from L1, so a new coefficient set
// never rebuilds anything.  Products and sums are done in uint32_t and
// reinterpreted (signed overflow is undefined in C++, the reference wraps);
// ">>" on a negative int is arithmetic under nvcc.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kClamp = (1 << 14) - 1;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t rounding_rshift(int32_t x, int shift) {
  if (shift <= 0) return x;
  const int32_t half = 1 << (shift - 1);
  return wadd(x, x >= 0 ? half : half - 1) >> shift;
}

template <int kVec>
__device__ __forceinline__ void horner(int32_t (&v)[kVec],
                                       const int32_t* __restrict__ coeffs,
                                       int n_coeffs, int x_frac) {
  int32_t acc[kVec];
  const int32_t top = __ldg(coeffs + n_coeffs - 1);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    v[e] = min(max(v[e], -kClamp), kClamp);
    acc[e] = top;
  }
  for (int k = n_coeffs - 2; k >= 0; --k) {
    const int32_t c = __ldg(coeffs + k);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      acc[e] = wadd(rounding_rshift(wmul(acc[e], v[e]), x_frac), c);
    }
  }
#pragma unroll
  for (int e = 0; e < kVec; ++e) v[e] = acc[e];
}

__global__ void __launch_bounds__(kThreads)
taylor_activation_kernel(const int32_t* __restrict__ x,
                         int32_t* __restrict__ out, int64_t n,
                         const int32_t* __restrict__ coeffs, int n_coeffs,
                         int x_frac, int vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t head = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    const int4* x4 = reinterpret_cast<const int4*>(x);
    int4* o4 = reinterpret_cast<int4*>(out);
    for (int64_t i = tid; i < n4; i += stride) {
      const int4 q = x4[i];
      int32_t v[4] = {q.x, q.y, q.z, q.w};
      horner<4>(v, coeffs, n_coeffs, x_frac);
      o4[i] = make_int4(v[0], v[1], v[2], v[3]);
    }
    head = n4 * 4;
  }
  for (int64_t i = head + tid; i < n; i += stride) {
    int32_t v[1] = {x[i]};
    horner<1>(v, coeffs, n_coeffs, x_frac);
    out[i] = v[0];
  }
}

}  // namespace

// x, out: n int32 codes (out may not alias x); coeffs: n_coeffs ascending
// int32 constants on the device.  x_frac <= 31.
extern "C" int taylor_activation_launch(const void* x, void* out, int64_t n,
                                        const void* coeffs, int n_coeffs,
                                        int x_frac, void* stream) {
  if (n < 0 || n_coeffs < 1 || x_frac > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0) ? 1 : 0;
  int device = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  const int64_t work = vec ? (n + 3) / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(n_sm > 0 ? n_sm : 132) * 16;
  if (blocks > cap) blocks = cap;
  taylor_activation_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<int32_t*>(out), n,
      static_cast<const int32_t*>(coeffs), n_coeffs, x_frac, vec);
  return static_cast<int>(cudaGetLastError());
}
