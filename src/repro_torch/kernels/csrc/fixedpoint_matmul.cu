// W8A8 fixed-point GEMM for Hopper (sm_90a) — the paper's C1 datapath.
//
// Replaces repro/kernels/fixedpoint_matmul.py::fixedpoint_matmul_pallas and
// computes the same float32 values bit for bit:
//
//   acc[m,n] = sum_k x[m,k] * w[k,n]            int8 x int8, int32 accumulator
//   out[m,n] = (float(acc) * xs[m]) * ws[n]      round to nearest, in that order
//
// x (M, K) int8 row-major, w (K, N) int8 row-major (the reference's layout),
// xs (M,) and ws (N,) float32, out (M, N) float32.  Any M, N, K >= 0.
//
// What bounds it on this card.  2·M·N·K operations on the int8 tensor cores
// (1,979 TOP/s dense) against M·K + K·N bytes in and 4·M·N out over
// 3.35 TB/s: at the 2048-token projections of the qwen2-1.5b layer the
// operations bound it; at one token (M = 1) the bytes of w do.
//
// Design (simple and right first; wgmma, TMA and a producer/consumer
// pipeline are later work).  A 128×128 output tile per block of 8 warps,
// each warp a 64×32 sub-tile of 4×4 mma.sync.m16n8k32 s8·s8→s32 products
// on int32 fragments.  The K loop steps by 64: a block stages its 128×64
// x tile (K-contiguous, as in memory) and its 64×128 w tile — transposed
// on the way into shared memory, four 4-byte rows at a time with byte
// permutes, so that every column is K-contiguous as the col operand wants —
// into rows padded to 80 bytes (the fragment loads are then free of bank
// conflicts), and loads the next tile into registers while the tensor
// cores work on this one.  The TPU kernel's int32 accumulator tile in VMEM
// becomes the fragments' registers; its sequential K grid axis becomes the
// loop inside the block.  Ragged M, N and K are predicated inside the
// kernel: rows, columns and depth past the edge load as zeros and are not
// stored.  16-byte loads of x need K % 16 == 0 and 4-byte loads of w
// N % 4 == 0 (and aligned pointers); otherwise the tile loads go byte by
// byte.  The epilogue is exactly __int2float_rn(acc) * xs[m], then
// * ws[n], each rounded to nearest (no contraction), as the reference does.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kLds = kBK + 16;  // padded row of a staged tile, in bytes
constexpr int kThreads = 256;   // 8 warps: 2 along M × 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kTilesM = kWarpM / 16;  // m16 tiles per warp
constexpr int kTilesN = kWarpN / 8;   // n8 tiles per warp

struct Staged {
  uint4 a[2];        // two 16-byte chunks of the x tile
  uint32_t b[2][4];  // two 4×4 byte blocks of the w tile, as loaded
};

__device__ __forceinline__ uint32_t load_bytes(const int8_t* p, int n_valid) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < n_valid) v |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * j);
  }
  return v;
}

__device__ __forceinline__ void load_tiles(const int8_t* __restrict__ x,
                                           const int8_t* __restrict__ w,
                                           int M, int N, int K, int m0, int n0,
                                           int k0, bool vec_a, bool vec_b,
                                           Staged& s) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;  // 512 chunks: 128 rows × 4
    const int m = m0 + (c >> 2);
    const int k = k0 + (c & 3) * 16;
    if (m < M && k < K && vec_a) {
      s.a[i] = *reinterpret_cast<const uint4*>(x + static_cast<size_t>(m) * K + k);
    } else {
      uint32_t v[4] = {0, 0, 0, 0};
      if (m < M) {
        const int8_t* row = x + static_cast<size_t>(m) * K;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int kq = k + 4 * q;
          if (kq < K) v[q] = load_bytes(row + kq, K - kq);
        }
      }
      s.a[i] = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = tid + i * kThreads;  // 512 blocks: 16 along K × 32 along N
    const int k = k0 + (blk >> 5) * 4;
    const int n = n0 + (blk & 31) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t v = 0;
      if (k + r < K && n < N) {
        const int8_t* p = w + static_cast<size_t>(k + r) * N + n;
        v = vec_b ? *reinterpret_cast<const uint32_t*>(p) : load_bytes(p, N - n);
      }
      s.b[i][r] = v;
    }
  }
}

__device__ __forceinline__ void store_tiles(int8_t* as, int8_t* bs,
                                            const Staged& s) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * kThreads;
    *reinterpret_cast<uint4*>(as + (c >> 2) * kLds + (c & 3) * 16) = s.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int blk = tid + i * kThreads;
    const int kb = (blk >> 5) * 4;
    const int nb = (blk & 31) * 4;
    const uint32_t* r = s.b[i];
    // column j gets byte j of rows k..k+3: a 4×4 byte transpose
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<uint32_t*>(bs + (nb + j) * kLds + kb) = col[j];
    }
  }
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
fixedpoint_matmul_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ xs,
                         const float* __restrict__ ws,
                         float* __restrict__ out, int M, int N, int K,
                         int vec_a, int vec_b) {
  __shared__ __align__(16) int8_t as[kBM * kLds];
  __shared__ __align__(16) int8_t bs[kBN * kLds];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // groupID
  const int t = lane & 3;   // thread in group
  const int wm = (warp >> 2) * kWarpM;
  const int wn = (warp & 3) * kWarpN;

  int32_t acc[kTilesM][kTilesN][4];
#pragma unroll
  for (int i = 0; i < kTilesM; ++i)
#pragma unroll
    for (int j = 0; j < kTilesN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int n_k = (K + kBK - 1) / kBK;
  Staged st;
  if (n_k > 0) {
    load_tiles(x, w, M, N, K, m0, n0, 0, vec_a, vec_b, st);
    store_tiles(as, bs, st);
  }
  __syncthreads();
  for (int kt = 0; kt < n_k; ++kt) {
    if (kt + 1 < n_k) {
      load_tiles(x, w, M, N, K, m0, n0, (kt + 1) * kBK, vec_a, vec_b, st);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t af[kTilesM][4];
      uint32_t bf[kTilesN][2];
#pragma unroll
      for (int i = 0; i < kTilesM; ++i) {
        const int8_t* r0 = as + (wm + i * 16 + g) * kLds + kk + 4 * t;
        const int8_t* r8 = r0 + 8 * kLds;
        af[i][0] = lds32(r0);
        af[i][1] = lds32(r8);
        af[i][2] = lds32(r0 + 16);
        af[i][3] = lds32(r8 + 16);
      }
#pragma unroll
      for (int j = 0; j < kTilesN; ++j) {
        const int8_t* c = bs + (wn + j * 8 + g) * kLds + kk + 4 * t;
        bf[j][0] = lds32(c);
        bf[j][1] = lds32(c + 16);
      }
#pragma unroll
      for (int i = 0; i < kTilesM; ++i)
#pragma unroll
        for (int j = 0; j < kTilesN; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
    if (kt + 1 < n_k) {
      store_tiles(as, bs, st);
      __syncthreads();
    }
  }

  // accumulator fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma unroll
  for (int i = 0; i < kTilesM; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float xm = xs[m];
      float* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
      for (int j = 0; j < kTilesN; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * t + e;
          if (n < N) {
            orow[n] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), xm), ws[n]);
          }
        }
      }
    }
  }
}

}  // namespace

// x (M, K) int8 · w (K, N) int8 · xs (M,) float32 · ws (N,) float32 →
// out (M, N) float32, all contiguous; out must not alias the inputs.
extern "C" int fixedpoint_matmul_launch(const void* x, const void* w,
                                        const void* xs, const void* ws,
                                        void* out, int M, int N, int K,
                                        void* stream) {
  if (M < 0 || N < 0 || K < 0 || M > 65535 * kBM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0 || N == 0) return static_cast<int>(cudaSuccess);
  const int vec_a = (K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 1 : 0;
  const int vec_b = (N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0) ? 1 : 0;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  fixedpoint_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<float*>(out), M, N, K, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}
