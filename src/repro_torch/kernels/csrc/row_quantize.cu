// Per-row symmetric activation quantization for Hopper (sm_90a): the
// activation half of the paper's W8A8 linear (C1).
//
// Replaces no TPU kernel: repro/core/quantize.py::absmax_quantize is plain
// jax.numpy, and the port's plain form (core/quantize.py) is a chain of
// about nine elementwise and reduction launches that read and write the
// whole (M, K) activation several times.  This kernel computes the same
// codes and scales bit for bit in one pass.  For each row of x:
//
//   absmax = max |x|            (NaN propagates, as torch.amax)
//   scale  = T(max(absmax, T(1e-8)) / qmax)        one IEEE division
//   code   = int8(clamp(rint(T(x / scale)), -qmax - 1, qmax))
//
// with T the input type (bf16, fp16 or fp32), every quotient correctly
// rounded as an IEEE division gives it (never a bare product with the
// reciprocal), every rounding to T round-to-nearest-even as PyTorch's own
// CUDA kernels round, rint half to even (torch.round), a NaN kept by the
// clamp and narrowed by the same float-to-int8 conversion PyTorch's copy
// uses.  It also writes the scale widened to float32, the operand the W8A8
// GEMM takes, which saves the plain path one more launch.
//
// What bounds it on this card.  Each element is read once (2 or 4 bytes)
// and its code written once (1 byte): 3 B per bf16 element over 3.35 TB/s,
// where the plain chain moves about 21 B.  Written as the chain is, though,
// each element costs a division (MUFU.RCP and its correction), a rounding
// to T, a rint and a float-to-int conversion, all of them on the SM's
// multi-function and conversion units at a fraction of the FMA rate, which
// alone take longer than HBM needs; hence the full-rate form below.
//
// Design.  A row is held on chip between its reduction and its codes, so
// it is read from HBM once.  A group of 32·w threads (w warps) takes one
// row; each thread loads up to kVpt 16-byte vectors of it into registers
// (neighbouring threads on neighbouring vectors), so w = ceil(vectors /
// 256) and kVpt = ceil(vectors / 32w): at K = 1536 in bf16 one warp of 6
// vectors a lane, at K = 8960 five warps of 7.  The absmax reduces by warp
// shuffles, then across the group's warps through shared memory.  Groups
// of 32 to 128 threads share a 256-thread block (8 rows a block at one
// warp a row), so the 8192 rows of a prefill fill the 132 SMs in about
// one wave at K = 1536.  Codes leave as 8-byte (bf16, fp16) or 4-byte
// (fp32) stores, the scale from the group's first thread.
//
// In bf16 and fp16 a row whose absmax is finite and whose scale is not 0
// computes its codes on full-rate instructions (FastCode below: Markstein's
// division from the row's reciprocal, T's rounding and rint on the float's
// bits), which give the exact form's codes; other rows, and fp32, run the
// exact form.
//
// A row whose vectors would not be 16-byte aligned (K or the row stride
// not a multiple of the vector's elements, or an unaligned start) runs the
// scalar form of the same kernel: one element per load, up to 32 a thread.
// A row longer than 32 warps hold (kMaxK) is refused; the wrapper leaves
// such rows to the plain path.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxVecVpt = 8;      // 16-byte vectors a thread holds
constexpr int kScalarVpt = 32;     // elements a thread holds, scalar form
constexpr int kMaxWarps = 32;      // warps a row may take
constexpr int kBlock = 256;        // threads of a block of several rows
constexpr int64_t kMaxK = static_cast<int64_t>(kMaxWarps) * 32 * kScalarVpt;

// The three input types: raw bits of one element in the low bits of a
// 32-bit word, to and from float as PyTorch's device code converts.
struct Bf16 {
  static constexpr int kBytes = 2;
  static constexpr int kDigits = 8;  // significand bits
  static __device__ __forceinline__ float to_float(uint32_t bits) {
    return __uint_as_float(bits << 16);
  }
  static __device__ __forceinline__ uint32_t round(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

struct F16 {
  static constexpr int kBytes = 2;
  static constexpr int kDigits = 11;
  static __device__ __forceinline__ float to_float(uint32_t bits) {
    return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
  }
  static __device__ __forceinline__ uint32_t round(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

struct F32 {
  static constexpr int kBytes = 4;
  static constexpr int kDigits = 24;
  static __device__ __forceinline__ float to_float(uint32_t bits) {
    return __uint_as_float(bits);
  }
  static __device__ __forceinline__ uint32_t round(float v) {
    return __float_as_uint(v);
  }
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Element j of a 16-byte vector (j a compile-time constant once unrolled).
template <typename F>
__device__ __forceinline__ float elem(const uint4& v, int j) {
  if constexpr (F::kBytes == 4) {
    return F::to_float(word(v, j));
  } else {
    return F::to_float((word(v, j / 2) >> (16 * (j % 2))) & 0xffffu);
  }
}

template <typename F>
__device__ __forceinline__ float elem(uint32_t v, int) {
  return F::to_float(v);
}

// max that keeps a NaN from either side, as torch.amax does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(b) || b > a) ? b : a;
}

// One element's code as the plain chain computes it: an IEEE division,
// the rounding to T, rint, the NaN-keeping clamp, the narrowing to int8.
template <typename F>
struct ExactCode {
  float scale, lo, hi;
  __device__ __forceinline__ uint32_t operator()(float x) const {
    float r = rintf(F::to_float(F::round(__fdiv_rn(x, scale))));
    if (!isnan(r)) r = fminf(fmaxf(r, lo), hi);
    return static_cast<uint8_t>(static_cast<int8_t>(r));
  }
};

// The same code in a 2-byte type for a row whose absmax is finite and whose
// scale is not 0, on full-rate instructions: the division, the rounding
// and rint are conversion-rate work (MUFU, F2F, FRND, F2I) that bound the
// exact form above HBM's rate.  Here |x / scale| <= 1.5 · qmax < 2^8
// (|x| <= c = max(absmax, floor) and scale = T(c / qmax), at least 2/3 of
// c / qmax even where it rounds into fp16's subnormals), so
//   q = RN(x / scale) by Markstein's correction from inv = RN(1 / scale):
//       q0 = RN(x · inv), q = RN(q0 + RN(x - q0 · scale) · inv);
//   T's rounding of q on its bits (round to nearest even at T's digits),
//       T's own where |q| >= 2^-14; below, within 0.5, whose code is 0
//       either way;
//   rint and the conversion by adding 1.5 · 2^23 (ties to even, since
//       that constant is even) and reading the integer off the bits;
//   the clamp on integers.
// The card tests hold it to the exact form over every (x, absmax) pair of
// non-negative finite bf16 and fp16 values.
template <typename F>
struct FastCode {
  float scale, inv;
  int lo, hi;
  __device__ __forceinline__ uint32_t operator()(float x) const {
    constexpr uint32_t kDrop = 24 - F::kDigits;
    const float q0 = __fmul_rn(x, inv);
    const float q = __fmaf_rn(__fmaf_rn(-q0, scale, x), inv, q0);
    uint32_t b = __float_as_uint(q);
    b = (b + ((1u << (kDrop - 1)) - 1) + ((b >> kDrop) & 1u)) & ~((1u << kDrop) - 1);
    const int i = __float_as_int(__fadd_rn(__uint_as_float(b), 12582912.0f)) - 0x4B400000;
    return static_cast<uint8_t>(min(max(i, lo), hi));
  }
};

// Codes of a thread's share of one row, stored as 8-byte (8 codes), 4-byte
// (4) or single-byte words.
template <typename F, bool kVec, int kVpt, typename Raw, typename Code>
__device__ __forceinline__ void store_codes(int8_t* dst, const Raw (&raw)[kVpt],
                                            int g, int group, int64_t units,
                                            const Code& code) {
  constexpr int kE = kVec ? 16 / F::kBytes : 1;
#pragma unroll
  for (int i = 0; i < kVpt; ++i) {
    const int64_t u = g + static_cast<int64_t>(i) * group;
    if (u < units) {
      if constexpr (kVec && kE == 8) {
        uint32_t lo_w = 0, hi_w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo_w |= code(elem<F>(raw[i], j)) << (8 * j);
          hi_w |= code(elem<F>(raw[i], j + 4)) << (8 * j);
        }
        reinterpret_cast<uint2*>(dst)[u] = make_uint2(lo_w, hi_w);
      } else if constexpr (kVec) {
        uint32_t w = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) w |= code(elem<F>(raw[i], j)) << (8 * j);
        reinterpret_cast<uint32_t*>(dst)[u] = w;
      } else {
        dst[u] = static_cast<int8_t>(code(elem<F>(raw[i], 0)));
      }
    }
  }
}

// kVec: 16-byte vectors of 16 / kBytes elements, else one element a load.
// group: threads a row (a multiple of 32); blockDim.x a multiple of it.
template <typename F, bool kVec, int kVpt>
__global__ void __launch_bounds__(1024)
row_quantize_kernel(const void* __restrict__ x, int8_t* __restrict__ codes,
                    void* __restrict__ scale, float* __restrict__ scale32,
                    int64_t m, int64_t k, int64_t stride, int group,
                    float qmax, float floor_, float lo, float hi) {
  constexpr int kE = kVec ? 16 / F::kBytes : 1;
  using Raw = std::conditional_t<kVec, uint4, uint32_t>;
  __shared__ float part[kMaxWarps];
  const int g = threadIdx.x % group;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / group) + threadIdx.x / group;
  const bool live = row < m;
  const int64_t units = k / kE;
  const char* src = static_cast<const char*>(x) + (live ? row * stride * F::kBytes : 0);

  Raw raw[kVpt];
#pragma unroll
  for (int i = 0; i < kVpt; ++i) {
    const int64_t u = g + static_cast<int64_t>(i) * group;
    if (live && u < units) {
      if constexpr (kVec) {
        raw[i] = reinterpret_cast<const uint4*>(src)[u];
      } else if constexpr (F::kBytes == 2) {
        raw[i] = reinterpret_cast<const uint16_t*>(src)[u];
      } else {
        raw[i] = reinterpret_cast<const uint32_t*>(src)[u];
      }
    }
  }
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < kVpt; ++i) {
    if (live && g + static_cast<int64_t>(i) * group < units) {
#pragma unroll
      for (int j = 0; j < kE; ++j) amax = nan_max(amax, fabsf(elem<F>(raw[i], j)));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = nan_max(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if (group > 32) {  // the same for every thread of the block
    const int warps = group / 32;
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
    __syncthreads();
    const int first = (threadIdx.x / group) * warps;
    amax = part[first];
    for (int w = 1; w < warps; ++w) amax = nan_max(amax, part[first + w]);
  }
  if (!live) return;

  const float clamped = isnan(amax) ? amax : fmaxf(amax, floor_);
  const uint32_t scale_bits = F::round(__fdiv_rn(clamped, qmax));
  const float sc = F::to_float(scale_bits);
  if (g == 0) {
    if constexpr (F::kBytes == 2) {
      static_cast<uint16_t*>(scale)[row] = static_cast<uint16_t>(scale_bits);
    } else {
      static_cast<uint32_t*>(scale)[row] = scale_bits;
    }
    if (scale32 != nullptr) scale32[row] = sc;
  }

  int8_t* dst = codes + row * k;
  if constexpr (F::kBytes == 2) {
    if (isfinite(amax) && sc > 0.0f) {
      store_codes<F, kVec, kVpt>(
          dst, raw, g, group, units,
          FastCode<F>{sc, __frcp_rn(sc), static_cast<int>(lo), static_cast<int>(hi)});
      return;
    }
  }
  store_codes<F, kVec, kVpt>(dst, raw, g, group, units, ExactCode<F>{sc, lo, hi});
}

template <typename F, bool kVec, int kVpt>
void launch(const void* x, void* codes, void* scale, float* scale32, int64_t m,
            int64_t k, int64_t stride, int group, float qmax, float floor_,
            float lo, float hi, cudaStream_t stream) {
  const int rows = group >= kBlock ? 1 : kBlock / group;
  const int64_t blocks = (m + rows - 1) / rows;
  row_quantize_kernel<F, kVec, kVpt><<<static_cast<unsigned>(blocks),
                                       rows * group, 0, stream>>>(
      x, static_cast<int8_t*>(codes), scale, scale32, m, k, stride, group,
      qmax, floor_, lo, hi);
}

template <typename F>
int dispatch(const void* x, void* codes, void* scale, float* scale32,
             int64_t m, int64_t k, int64_t stride, float qmax, float floor_,
             cudaStream_t stream) {
  constexpr int kE = 16 / F::kBytes;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   k % kE == 0 && stride % kE == 0;
  const float lo = -qmax - 1.0f, hi = qmax;
  const int64_t units = vec ? k / kE : k;
  const int64_t per_warp = 32 * static_cast<int64_t>(vec ? kMaxVecVpt : kScalarVpt);
  const int64_t warps = (units + per_warp - 1) / per_warp;
  if (warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const int group = 32 * static_cast<int>(warps);
  if (!vec) {
    launch<F, false, kScalarVpt>(x, codes, scale, scale32, m, k, stride,
                                 group, qmax, floor_, lo, hi, stream);
    return static_cast<int>(cudaGetLastError());
  }
  switch ((units + group - 1) / group) {
#define ROW_QUANTIZE_CASE(V)                                                  \
  case V:                                                                     \
    launch<F, true, V>(x, codes, scale, scale32, m, k, stride, group, qmax,   \
                       floor_, lo, hi, stream);                               \
    break;
    ROW_QUANTIZE_CASE(1)
    ROW_QUANTIZE_CASE(2)
    ROW_QUANTIZE_CASE(3)
    ROW_QUANTIZE_CASE(4)
    ROW_QUANTIZE_CASE(5)
    ROW_QUANTIZE_CASE(6)
    ROW_QUANTIZE_CASE(7)
    ROW_QUANTIZE_CASE(8)
#undef ROW_QUANTIZE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: m rows of k elements of type dtype (0 bf16, 1 fp16, 2 fp32), row i at
// x + i * stride elements (stride >= 0), the elements of a row contiguous;
// 1 <= k <= kMaxK.  codes: m × k int8, contiguous.  scale: m values of
// type dtype.  scale32: m float32 values, or null.  qmax = 2^(bits-1) - 1;
// floor_ = 1e-8 rounded to dtype.
extern "C" int row_quantize_launch(const void* x, void* codes, void* scale,
                                   void* scale32, int64_t m, int64_t k,
                                   int64_t stride, int dtype, float qmax,
                                   float floor_, void* stream) {
  if (m < 0 || k < 1 || k > kMaxK || stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  auto s = static_cast<cudaStream_t>(stream);
  auto s32 = static_cast<float*>(scale32);
  switch (dtype) {
    case 0: return dispatch<Bf16>(x, codes, scale, s32, m, k, stride, qmax, floor_, s);
    case 1: return dispatch<F16>(x, codes, scale, s32, m, k, stride, qmax, floor_, s);
    case 2: return dispatch<F32>(x, codes, scale, s32, m, k, stride, qmax, floor_, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
