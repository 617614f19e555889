// Fused multi-model fixed-point MLP for Hopper (sm_90a).
//
// Replaces repro/kernels/fixedpoint_mlp.py::fixedpoint_mlp_pallas (both
// weight lanes, "int16" and "int8") and computes the same int32 codes bit for
// bit.  Per packet p with table slot s, for each layer l < L:
//
//   acc = x · W[s,l] + b[s,l]          int32, wrapping; b at 2·frac bits
//   y   = rounding_rshift(acc, frac)   ties away from zero
//   y   = activation[act[s,l]](y)      0 identity, 1 relu, 2 Taylor sigmoid,
//                                      3 leaky relu, 4 hard sigmoid, else id.
//   y   = lane_clamp(y, 8)             int8 lane only (also at entry)
//   x   = layer_on[s,l] ? y : x
//
// What bounds it on this card.  At the server's defaults (M=16 models, L=4
// layers, W=32 lanes, B=2048 packets per batch) one batch is 2·B·L·W² ≈ 17 M
// integer operations over ≈ 0.7 MB of inputs, outputs and tables, so by the
// card's peaks both bounds are well under a microsecond; in practice the
// kernel is bound by latency: the per-layer dependency chain inside each
// packet and the load of the packet's own W×W weight block.  Hopper has no
// int32 tensor-core MMA and W ≤ 32 makes each packet's layer a tiny
// matrix-vector product, so this is CUDA-core work.
//
// Design.  One warp per packet; lane j owns output column j (and j+32, j+64,
// j+96 when W > 32, up to kMaxWidth).  The warp keeps the packet's current
// activations in shared memory, so every lane reads x_i as a broadcast, and
// reads column j of W[s,l] — for fixed i the 32 lanes read 32 adjacent
// weights, one coalesced request.  The kernel reads the control plane's own
// (M, L, W, W) / (M, L, W) / (M, L) tables, so no per-batch transpose or
// relayout is needed; the tables (128 KiB of int16 at the defaults) stay hot
// in L1/L2 across the warps of a batch.  frac, the leaky slope and the ≤8
// Taylor constants are kernel arguments; tables are pointers, never compiled
// in, so installing a model never rebuilds anything.
//
// Integer discipline.  Signed overflow is undefined in C++, while the
// reference wraps: every product and sum is done in uint32_t and
// reinterpreted.  ">>" on a negative int is arithmetic under nvcc (and
// defined so by C++20).  A slot outside [0, M) selects no model, exactly as
// the masked-GEMM formulation: every layer is off and the packet returns its
// (lane-clamped) input.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxWidth = 128;
constexpr int kMaxCols = kMaxWidth / 32;
constexpr int kMaxCoeffs = 8;

struct Consts {
  int32_t sig[kMaxCoeffs];  // ascending Taylor constants at frac bits
  int n_sig;
  int frac;
  int leaky_alpha_q;
};

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

__device__ __forceinline__ int32_t clamp8(int32_t v) {
  return min(max(v, -128), 127);
}

__device__ __forceinline__ int32_t activate(int32_t y, int op, const Consts& k) {
  switch (op) {
    case 1:
      return y > 0 ? y : 0;
    case 2: {
      const int32_t xc = min(max(y, -(1 << 14)), 1 << 14);
      int32_t s = 0;
#pragma unroll
      for (int c = kMaxCoeffs - 1; c >= 0; --c) {
        if (c == k.n_sig - 1) {
          s = k.sig[c];
        } else if (c < k.n_sig - 1) {
          s = wadd(rounding_rshift(wmul(s, xc), k.frac), k.sig[c]);
        }
      }
      return s;
    }
    case 3:
      return y > 0 ? y : rounding_rshift(wmul(y, k.leaky_alpha_q), k.frac);
    case 4: {
      const int32_t h = wadd(1 << (k.frac - 1), rounding_rshift(y, 2));
      return min(max(h, 0), 1 << k.frac);
    }
    default:
      return y;
  }
}

template <typename WT, bool kLane8>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fixedpoint_mlp_kernel(const int32_t* __restrict__ x,
                      const int32_t* __restrict__ slot,
                      const WT* __restrict__ w,
                      const int32_t* __restrict__ b,
                      const int32_t* __restrict__ act,
                      const int32_t* __restrict__ on,
                      int32_t* __restrict__ out,
                      int n_batch, int n_models, int n_layers, int width,
                      Consts k) {
  __shared__ int32_t xs[kWarpsPerBlock][kMaxWidth];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n_batch) return;  // warp-uniform
  int32_t* xw = xs[warp];
  const int32_t* xp = x + static_cast<size_t>(p) * width;

  int32_t xr[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = lane + 32 * c;
    xr[c] = 0;
    if (j < width) {
      int32_t v = xp[j];
      if (kLane8) v = clamp8(v);
      xr[c] = v;
      xw[j] = v;
    }
  }
  __syncwarp();

  const int s = slot[p];
  if (s >= 0 && s < n_models) {  // warp-uniform
    for (int l = 0; l < n_layers; ++l) {
      const int ml = s * n_layers + l;
      const int op = act[ml];
      const bool layer_on = on[ml] > 0;
      const WT* wl = w + static_cast<size_t>(ml) * width * width;
      const int32_t* bl = b + static_cast<size_t>(ml) * width;
      int32_t acc[kMaxCols];
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int j = lane + 32 * c;
        acc[c] = j < width ? bl[j] : 0;
      }
      for (int i = 0; i < width; ++i) {
        const int32_t xi = xw[i];
        const WT* wrow = wl + static_cast<size_t>(i) * width;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int j = lane + 32 * c;
          if (j < width) acc[c] = wadd(acc[c], wmul(xi, static_cast<int32_t>(wrow[j])));
        }
      }
      __syncwarp();  // every lane has read x before any lane overwrites it
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int j = lane + 32 * c;
        if (j < width) {
          int32_t y = activate(rounding_rshift(acc[c], k.frac), op, k);
          if (kLane8) y = clamp8(y);
          if (layer_on) xr[c] = y;
          xw[j] = xr[c];
        }
      }
      __syncwarp();
    }
  }

  int32_t* op = out + static_cast<size_t>(p) * width;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = lane + 32 * c;
    if (j < width) op[j] = xr[c];
  }
}

template <typename WT, bool kLane8>
void launch(const void* x, const void* slot, const void* w, const void* b,
            const void* act, const void* on, void* out, int n_batch,
            int n_models, int n_layers, int width, const Consts& k,
            cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  fixedpoint_mlp_kernel<WT, kLane8><<<grid, block, 0, stream>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(slot),
      static_cast<const WT*>(w), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(act), static_cast<const int32_t*>(on),
      static_cast<int32_t*>(out), n_batch, n_models, n_layers, width, k);
}

}  // namespace

extern "C" int fixedpoint_mlp_max_width() { return kMaxWidth; }

// x (B, W) int32 · slot (B,) int32 · w (M, L, W, W) of w_bytes-byte signed
// ints · b (M, L, W) int32 · act, on (M, L) int32 → out (B, W) int32.
// lane8 != 0 selects the int8 weight lane (saturating codes into int8).
extern "C" int fixedpoint_mlp_launch(const void* x, const void* slot,
                                     const void* w, int w_bytes,
                                     const void* b, const void* act,
                                     const void* on, void* out, int n_batch,
                                     int n_models, int n_layers, int width,
                                     int frac, const int32_t* sig, int n_sig,
                                     int leaky_alpha_q, int lane8,
                                     void* stream) {
  if (width < 1 || width > kMaxWidth || n_sig < 1 || n_sig > kMaxCoeffs ||
      frac < 1 || frac > 30 || n_batch < 0 || n_models < 1 || n_layers < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_batch == 0) return static_cast<int>(cudaSuccess);
  Consts k{};
  for (int c = 0; c < n_sig; ++c) k.sig[c] = sig[c];
  k.n_sig = n_sig;
  k.frac = frac;
  k.leaky_alpha_q = leaky_alpha_q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lane8) {
    if (w_bytes != 1) return static_cast<int>(cudaErrorInvalidValue);
    launch<int8_t, true>(x, slot, w, b, act, on, out, n_batch, n_models, n_layers, width, k, st);
  } else if (w_bytes == 1) {
    launch<int8_t, false>(x, slot, w, b, act, on, out, n_batch, n_models, n_layers, width, k, st);
  } else if (w_bytes == 2) {
    launch<int16_t, false>(x, slot, w, b, act, on, out, n_batch, n_models, n_layers, width, k, st);
  } else if (w_bytes == 4) {
    launch<int32_t, false>(x, slot, w, b, act, on, out, n_batch, n_models, n_layers, width, k, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
