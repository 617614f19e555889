// WKV chunk scan for Hopper (sm_90a) — the RWKV-6 token mix's linear
// recurrence in its chunked form, float32 throughout.
//
// Replaces repro/kernels/wkv_scan.py::wkv_scan_pallas.  For every (B·H) row,
// over its NC chunks in order, with the D×D state S starting at zero:
//
//   scores = strict_tril(a·bᵀ)                       (C×C)
//   o      = scores·v + diag ⊙ v + a·S               (C×D)
//   S      ← S ⊙ totᵀ + (b ⊙ tot)ᵀ·v                 (row d of S scaled by tot[d])
//
// a, b, v: (BH, NC, C, D); tot: (BH, NC, 1, D); diag: (BH, NC, C, 1);
// o: (BH, NC, C, D).  All float32, contiguous.  D ≤ 64, 1 ≤ C ≤ 256.
//
// What bounds it on this card.  Per chunk the four products cost
// 2C²D + 2C²D + 2CD² + 2CD² float operations against 4·(4CD + C + D) bytes
// of operands and output; at C = D = 64 that is 2.1 MFLOP per 66 KB, about
// 32 operations per byte, above the FP32 CUDA cores' balance point
// (67 TFLOP/s over 3.35 TB/s = 20 per byte), so the kernel is bound by its
// float operations.  The operands must stay in full float32:
// b = k·exp(−cum) reaches e^30 and cancels against a = r·exp(cum_prev), so
// TF32's 10-bit mantissa (and bf16) cannot hold the 2e-5 the reference's
// tests ask of this kernel.  The products therefore
// run as FP32 FMAs on the CUDA cores, not on the tensor cores.
//
// Design.  The TPU kernel's grid is (BH, NC) with NC sequential and the
// state in VMEM scratch.  Here one block of 256 threads owns one BH row and
// loops over its chunks, so the state never leaves shared memory.  Each
// chunk's b (rows padded to D+1 floats, so that lanes reading different
// rows hit different banks) and v are staged in shared memory; the queries
// go in row blocks of 32 (the a rows and a 32×C score tile; a whole C×C
// tile is 256 KiB at C = 256, more than a block may hold).  Every product
// is a register micro-tile: a warp owns a set of output rows (its A
// operand is a shared-memory broadcast) and each lane owns output columns
// lane, lane+32 (its B operand is one conflict-free row of shared memory).
// Score columns at or right of the diagonal are stored as zeros, and the
// score·v product runs only over the columns the row block can see.  The
// state update scales b by tot in place, then every thread updates its own
// elements of S.  Shared memory at C = 256, D = 64 is 190,720 bytes; at the
// rwkv6-3b prefill geometry (C = D = 64) 66,304 bytes, three blocks an SM.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 4;                 // rows per warp in a row block
constexpr int kRows = kWarps * kRowTile;    // 32 query rows per row block
constexpr int kStateRows = 8;               // state rows per warp (D ≤ 64)
constexpr int kCols = 2;                    // columns per lane (≤ 64)
constexpr int kMaxD = 64;
constexpr int kMaxC = 256;

__host__ __device__ inline int64_t smem_floats(int c, int d) {
  return static_cast<int64_t>(c) * (d + 1)  // b, padded rows
         + static_cast<int64_t>(c) * d      // v
         + static_cast<int64_t>(d) * d      // S
         + static_cast<int64_t>(kRows) * d  // a rows of the row block
         + static_cast<int64_t>(kRows) * c  // scores of the row block
         + d + c;                           // tot, diag
}

__global__ void __launch_bounds__(kThreads)
wkv_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ v, const float* __restrict__ tot,
                const float* __restrict__ diag, float* __restrict__ o,
                int nc, int c, int d) {
  extern __shared__ float smem[];
  const int dp = d + 1;
  float* sb = smem;              // c × dp
  float* sv = sb + c * dp;       // c × d
  float* sS = sv + c * d;        // d × d
  float* sa = sS + d * d;        // kRows × d
  float* ssc = sa + kRows * d;   // kRows × c
  float* stot = ssc + kRows * c; // d
  float* sdiag = stot + d;       // c

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t row = blockIdx.x;
  const int cd = c * d;

  for (int i = tid; i < d * d; i += kThreads) sS[i] = 0.f;

  // this lane's output columns, clamped for loads and masked for stores
  int col[kCols];
  bool col_ok[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    col[j] = lane + 32 * j;
    col_ok[j] = col[j] < d;
    col[j] = col_ok[j] ? col[j] : d - 1;
  }

  for (int ch = 0; ch < nc; ++ch) {
    const int64_t cell = row * nc + ch;
    const float* ga = a + cell * cd;
    const float* gb = b + cell * cd;
    const float* gv = v + cell * cd;
    float* go = o + cell * cd;

    // -- stage b (padded rows), v, tot, diag ------------------------------
    for (int i = tid; i < cd; i += kThreads) {
      const int s = i / d;
      sb[s * dp + (i - s * d)] = __ldg(gb + i);
      sv[i] = __ldg(gv + i);
    }
    for (int i = tid; i < d; i += kThreads) stot[i] = __ldg(tot + cell * d + i);
    for (int i = tid; i < c; i += kThreads) sdiag[i] = __ldg(diag + cell * c + i);
    __syncthreads();

    // -- outputs, one row block of kRows queries at a time ----------------
    for (int r0 = 0; r0 < c; r0 += kRows) {
      const int nr = min(kRows, c - r0);
      const int ns = r0 + nr - 1;  // key columns this block's rows can see
      for (int i = tid; i < nr * d; i += kThreads) sa[i] = __ldg(ga + r0 * d + i);
      __syncthreads();

      // scores[r][s] = a[r0+r]·b[s] for s < r0+r, else 0; s < ns
      for (int s0 = 0; s0 < ns; s0 += 32 * kCols) {
        float acc[kRowTile][kCols] = {};
        int sc[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[j] = min(s0 + lane + 32 * j, c - 1);
        for (int k = 0; k < d; ++k) {
          float av[kRowTile], bv[kCols];
#pragma unroll
          for (int i = 0; i < kRowTile; ++i) av[i] = sa[(warp + kWarps * i) * d + k];
#pragma unroll
          for (int j = 0; j < kCols; ++j) bv[j] = sb[sc[j] * dp + k];
#pragma unroll
          for (int i = 0; i < kRowTile; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRowTile; ++i) {
          const int r = warp + kWarps * i;
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const int s = s0 + lane + 32 * j;
            if (r < nr && s < ns) ssc[r * c + s] = s < r0 + r ? acc[i][j] : 0.f;
          }
        }
      }
      __syncthreads();

      // o[t] = scores[t]·v + a[t]·S + diag[t]·v[t]
      float acc[kRowTile][kCols] = {};
      for (int s = 0; s < ns; ++s) {
        float av[kRowTile], bv[kCols];
#pragma unroll
        for (int i = 0; i < kRowTile; ++i) av[i] = ssc[(warp + kWarps * i) * c + s];
#pragma unroll
        for (int j = 0; j < kCols; ++j) bv[j] = sv[s * d + col[j]];
#pragma unroll
        for (int i = 0; i < kRowTile; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      for (int k = 0; k < d; ++k) {
        float av[kRowTile], bv[kCols];
#pragma unroll
        for (int i = 0; i < kRowTile; ++i) av[i] = sa[(warp + kWarps * i) * d + k];
#pragma unroll
        for (int j = 0; j < kCols; ++j) bv[j] = sS[k * d + col[j]];
#pragma unroll
        for (int i = 0; i < kRowTile; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kRowTile; ++i) {
        const int r = warp + kWarps * i;
        if (r >= nr) continue;
        const int t = r0 + r;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          if (col_ok[j]) go[t * d + col[j]] = acc[i][j] + sdiag[t] * sv[t * d + col[j]];
        }
      }
      __syncthreads();  // sa and ssc are rewritten by the next row block
    }

    // -- state: S ← S ⊙ totᵀ + (b ⊙ tot)ᵀ·v ------------------------------
    for (int i = tid; i < cd; i += kThreads) {
      const int s = i / d;
      const int e = i - s * d;
      sb[s * dp + e] *= stot[e];
    }
    __syncthreads();
    float acc[kStateRows][kCols] = {};
    int m[kStateRows];
#pragma unroll
    for (int i = 0; i < kStateRows; ++i) m[i] = min(warp + kWarps * i, d - 1);
    for (int s = 0; s < c; ++s) {
      float av[kStateRows], bv[kCols];
#pragma unroll
      for (int i = 0; i < kStateRows; ++i) av[i] = sb[s * dp + m[i]];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bv[j] = sv[s * d + col[j]];
#pragma unroll
      for (int i = 0; i < kStateRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kStateRows; ++i) {
      const int r = warp + kWarps * i;
      if (r >= d) continue;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        if (col_ok[j]) {
          float* sp = sS + r * d + col[j];
          *sp = *sp * stot[r] + acc[i][j];
        }
      }
    }
    __syncthreads();  // the next chunk restages b and v and reads S
  }
}

}  // namespace

// a, b, v, o: (bh, nc, c, d); tot: (bh, nc, 1, d); diag: (bh, nc, c, 1);
// float32, contiguous, o not aliasing an input.  1 <= d <= 64,
// 1 <= c <= 256, 0 <= bh < 2^31, nc >= 0.
extern "C" int wkv_scan_launch(const void* a, const void* b, const void* v,
                               const void* tot, const void* diag, void* o,
                               int64_t bh, int64_t nc, int c, int d,
                               void* stream) {
  if (bh < 0 || bh > INT32_MAX || nc < 0 || nc > INT32_MAX || c < 1 ||
      c > kMaxC || d < 1 || d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || nc == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(smem_floats(c, d)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv_scan_kernel<<<static_cast<unsigned>(bh), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(v), static_cast<const float*>(tot),
      static_cast<const float*>(diag), static_cast<float*>(o),
      static_cast<int>(nc), c, d);
  return static_cast<int>(cudaGetLastError());
}
