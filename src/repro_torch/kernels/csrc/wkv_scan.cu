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
// Design (wkv_scan_launch): two launches, so that the chunks of a row run
// in parallel and only the state's cheap recurrence stays sequential.
//
//   1. wkv_intra_kernel, one block of 256 threads per (row, chunk):
//      o ← strict_tril(a·bᵀ)·v + diag ⊙ v, and the chunk's state increment
//      ΔS = (b ⊙ tot)ᵀ·v into a (BH, NC, D, D) workspace.  Queries and keys
//      go in blocks of 64 (one block each at C = 64); a·bᵀ, scores·v and
//      (b ⊙ tot)ᵀ·v are 64×64 tiles in which each thread owns a 4×4
//      register micro-tile, fed by 128-bit shared-memory loads (two per 16
//      FMAs); b is scaled by tot in registers (b·tot rounded, then the
//      FMA, as b ⊙ tot is).  Every tile is staged row-major in rows padded
//      to 68 floats;
//      a thread owns the rows ty + 16i, so that the 128-bit loads of one
//      quarter-warp fall in distinct banks, and a·bᵀ runs over the columns
//      of both operands 4 at a time.  Scores at or right of the diagonal
//      are stored as zeros and the diagonal block's scores·v runs only over
//      the keys a thread's rows can see.
//   2. wkv_state_kernel, one block of 64 threads per (row, 16 columns of
//      S): walks the row's chunks in order with its D×16 slice of S in
//      shared memory, adds a·S (4×4 micro-tiles) to kernel 1's part of o
//      and sets S ← S ⊙ totᵀ + ΔS.  Its critical path is the latency of
//      each chunk's loads, so the next chunk's a is copied into a second
//      shared-memory buffer (cp.async) while this chunk's products run,
//      and o and ΔS are loaded before the products and used after them.
//      The slices of one row are adjacent blocks and read a from the L2
//      together.
//
// Grid at the rwkv6-3b prefill geometry (BH = 160, NC = 32, C = D = 64):
// 5,120 blocks of kernel 1 (69,888 B of shared memory, three per SM) and 640
// of kernel 2 (38,912 B).  The workspace adds 4·BH·NC·D² bytes written and read back.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kMaxD = 64;
constexpr int kMaxC = 256;

constexpr int kBlk = 64;        // query / key block
constexpr int kLd = kBlk + 4;   // padded row, in floats (keeps float4 alignment)
constexpr int kIntraThreads = 256;
constexpr int kSlice = 16;      // S columns per state block
constexpr int kStateThreads = 64;
constexpr int kIntraSmem = (4 * kBlk * kLd + kBlk) * 4;
constexpr int kStateSmem = (2 * kBlk * kLd + kMaxD * kSlice) * 4;

// Stage rows [0, n) of a (·, d) float32 block at `src` into a 64×64 tile
// dst[r·kLd + e] (zeros outside).  vec: d % 4 == 0 (16-byte loads and stores).
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ src,
                                      int n, int d, bool vec, int tid, int nthreads) {
  if (vec) {
    for (int i = tid; i < kBlk * (kBlk / 4); i += nthreads) {
      const int r = i >> 4;
      const int e = (i & 15) << 2;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n && e < d) {
        x = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r) * d + e));
      }
      *reinterpret_cast<float4*>(dst + r * kLd + e) = x;
    }
  } else {
    for (int i = tid; i < kBlk * kBlk; i += nthreads) {
      const int r = i >> 6;
      const int e = i & 63;
      float x = 0.f;
      if (r < n && e < d) {
        x = __ldg(src + static_cast<size_t>(r) * d + e);
      }
      dst[r * kLd + e] = x;
    }
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] += x · y[j] for row i
__device__ __forceinline__ void outer4(float (&acc)[4][4], int i, float x, const float4 y) {
  acc[i][0] = fmaf(x, y.x, acc[i][0]);
  acc[i][1] = fmaf(x, y.y, acc[i][1]);
  acc[i][2] = fmaf(x, y.z, acc[i][2]);
  acc[i][3] = fmaf(x, y.w, acc[i][3]);
}

// Store columns c0 .. c0+3 (those below d) of one row, if `valid`.
__device__ __forceinline__ void store_row4(float* __restrict__ row, const float (&x)[4],
                                           bool valid, int c0, int d, bool vec) {
  if (!valid || c0 >= d) return;
  if (vec) {
    *reinterpret_cast<float4*>(row + c0) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (c0 + j < d) row[c0 + j] = x[j];
    }
  }
}

__global__ void __launch_bounds__(kIntraThreads, 3)
wkv_intra_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ v, const float* __restrict__ tot,
                 const float* __restrict__ diag, float* __restrict__ o,
                 float* __restrict__ dstate, int c, int d) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* as = smem;                // as[r][e]: the query block's a
  float* bk = as + kBlk * kLd;     // bk[s][e]: the key block's b
  float* vs = bk + kBlk * kLd;     // vs[s][f]
  float* ps = vs + kBlk * kLd;     // ps[r][s]: masked scores
  float* sdiag = ps + kBlk * kLd;  // the query block's diag

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // rows ty + 16i of a 64×64 tile
  const int tx = tid & 15;  // key columns tx + 16j; value columns 4tx .. 4tx+3
  const int64_t cell = blockIdx.x;
  const int64_t cd = static_cast<int64_t>(c) * d;
  const float* ga = a + cell * cd;
  const float* gb = b + cell * cd;
  const float* gv = v + cell * cd;
  const float* gtot = tot + cell * d;
  const bool vec = (d & 3) == 0;
  const int d4 = (d + 3) & ~3;

  float ds[4][4] = {};  // ΔS rows 4ty .. 4ty+3, columns 4tx .. 4tx+3
  float4 tot4 = make_float4(0.f, 0.f, 0.f, 0.f);  // tot[4ty .. 4ty+3]
  if (4 * ty + 0 < d) tot4.x = __ldg(gtot + 4 * ty + 0);
  if (4 * ty + 1 < d) tot4.y = __ldg(gtot + 4 * ty + 1);
  if (4 * ty + 2 < d) tot4.z = __ldg(gtot + 4 * ty + 2);
  if (4 * ty + 3 < d) tot4.w = __ldg(gtot + 4 * ty + 3);
  const int nqb = (c + kBlk - 1) / kBlk;
  for (int qb = 0; qb < nqb; ++qb) {
    const int q0 = qb * kBlk;
    const int nq = min(kBlk, c - q0);
    float acc[4][4] = {};  // o rows ty + 16i, columns 4tx .. 4tx+3
    for (int kb = 0; kb <= qb; ++kb) {
      const int k0 = kb * kBlk;
      const int nk = min(kBlk, c - k0);
      const bool on_diag = kb == qb;
      __syncthreads();  // the previous block's tiles are no longer read
      if (kb == 0) stage(as, ga + q0 * d, nq, d, vec, tid, kIntraThreads);
      stage(bk, gb + k0 * d, nk, d, vec, tid, kIntraThreads);
      stage(vs, gv + k0 * d, nk, d, vec, tid, kIntraThreads);
      if (on_diag) {
        for (int i = tid; i < kBlk; i += kIntraThreads) {
          sdiag[i] = i < nq ? __ldg(diag + cell * c + q0 + i) : 0.f;
        }
      }
      __syncthreads();

      // scores[r][s] = a[r]·b[s], kept where key k0+s < query q0+r
      float sc[4][4] = {};
      for (int e = 0; e < d4; e += 4) {
        float4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = lds4(as + (ty + 16 * i) * kLd + e);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 y = lds4(bk + (tx + 16 * j) * kLd + e);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            sc[i][j] = fmaf(x[i].x, y.x, sc[i][j]);
            sc[i][j] = fmaf(x[i].y, y.y, sc[i][j]);
            sc[i][j] = fmaf(x[i].z, y.z, sc[i][j]);
            sc[i][j] = fmaf(x[i].w, y.w, sc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, s = tx + 16 * j;
          ps[r * kLd + s] = (!on_diag || s < r) ? sc[i][j] : 0.f;
        }
      __syncthreads();

      // acc[r][f] += Σ_s scores[r][s] · v[s][f]: on the diagonal only the
      // keys below this thread's last row (ty + 48), zeros past the mask
      const int s_end = on_diag ? min(nk, ty + 3 * 16) : nk;
      for (int s = 0; s < s_end; s += 4) {
        float4 p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) p[i] = lds4(ps + (ty + 16 * i) * kLd + s);
        const float4 y0 = lds4(vs + s * kLd + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) outer4(acc, i, p[i].x, y0);
        const float4 y1 = lds4(vs + (s + 1) * kLd + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) outer4(acc, i, p[i].y, y1);
        const float4 y2 = lds4(vs + (s + 2) * kLd + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) outer4(acc, i, p[i].z, y2);
        const float4 y3 = lds4(vs + (s + 3) * kLd + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) outer4(acc, i, p[i].w, y3);
      }
      // ΔS[e][f] += Σ_s (b[s][e]·tot[e]) · v[s][f], each key block once
      if (on_diag) {
        for (int s = 0; s < nk; ++s) {
          const float4 x = lds4(bk + s * kLd + 4 * ty);
          const float4 y = lds4(vs + s * kLd + 4 * tx);
          outer4(ds, 0, __fmul_rn(x.x, tot4.x), y);
          outer4(ds, 1, __fmul_rn(x.y, tot4.y), y);
          outer4(ds, 2, __fmul_rn(x.z, tot4.z), y);
          outer4(ds, 3, __fmul_rn(x.w, tot4.w), y);
        }
      }
    }
    // + diag ⊙ v: vs holds the diagonal key block, the query rows' own v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      outer4(acc, i, sdiag[r], lds4(vs + r * kLd + 4 * tx));
      store_row4(o + cell * cd + static_cast<int64_t>(q0 + r) * d, acc[i], r < nq, 4 * tx,
                 d, vec);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    store_row4(dstate + cell * d * d + static_cast<int64_t>(4 * ty + i) * d, ds[i],
               4 * ty + i < d, 4 * tx, d, vec);
  }
}

// 16- or 4-byte asynchronous copy global → shared; src_bytes == 0 writes
// zeros (the source is not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const uint32_t d = smem_addr(dst);
  if (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__global__ void __launch_bounds__(kStateThreads)
wkv_state_kernel(const float* __restrict__ a, const float* __restrict__ tot,
                 const float* __restrict__ dstate, float* __restrict__ o, int nc,
                 int c, int d, int n_slices) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* abuf = smem;                  // two 64×kLd row blocks of a, row-major
  float* sS = abuf + 2 * kBlk * kLd;   // sS[e·kSlice + j] = S[e][c0 + j]

  const int tid = threadIdx.x;
  const int rg = tid >> 2;        // rows rg + 16i (i < 4) of a row block
  const int cg = tid & 3;         // slice columns 4cg .. 4cg+3
  const int64_t row = blockIdx.x / n_slices;
  const int c0 = (blockIdx.x - static_cast<int>(row) * n_slices) * kSlice;
  const int64_t cd = static_cast<int64_t>(c) * d;
  const bool vec = (d & 3) == 0;
  const int d4 = (d + 3) & ~3;
  const int col = c0 + 4 * cg;
  const int nrb = (c + kBlk - 1) / kBlk;
  const int steps = nc * nrb;     // (chunk, row block) pairs, in order

  for (int i = tid; i < kMaxD * kSlice; i += kStateThreads) sS[i] = 0.f;

  // a of one step into buffer `buf`, zeros outside the block's rows and d
  auto fetch_a = [&](int step, int buf) {
    const int ch = step / nrb;
    const int t0 = (step - ch * nrb) * kBlk;
    const int n = min(kBlk, c - t0);
    const float* ga = a + (row * nc + ch) * cd + static_cast<int64_t>(t0) * d;
    float* dst = abuf + buf * kBlk * kLd;
    if (vec) {
      for (int i = tid; i < kBlk * (kBlk / 4); i += kStateThreads) {
        const int r = i >> 4;
        const int e = (i & 15) << 2;
        const bool ok = r < n && e < d;
        cp_async<16>(dst + r * kLd + e, ok ? ga + r * d + e : ga, ok);
      }
    } else {
      for (int i = tid; i < kBlk * kBlk; i += kStateThreads) {
        const int r = i >> 6;
        const int e = i & 63;
        const bool ok = r < n && e < d;
        cp_async<4>(dst + r * kLd + e, ok ? ga + r * d + e : ga, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  fetch_a(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int ch = step / nrb;
    const int t0 = (step - ch * nrb) * kBlk;
    const int64_t cell = row * nc + ch;
    const bool chunk_end = t0 + kBlk >= c;
    float* go = o + cell * cd;
    // this step's o tile (kernel 1's part) and, at a chunk's end, its ΔS
    // elements and decays: loaded now, used after the products
    float intra[4][4], acc[4][4] = {}, ds[16], dk[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + rg + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        intra[i][j] = (t < c && col + j < d) ? go[static_cast<int64_t>(t) * d + col + j] : 0.f;
      }
    }
    if (chunk_end) {
      const float* gds = dstate + cell * d * d;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int e = (tid >> 4) + 4 * q;
        const int j = tid & 15;
        ds[q] = (e < d && c0 + j < d) ? __ldg(gds + e * d + c0 + j) : 0.f;
        dk[q] = e < d ? __ldg(tot + cell * d + e) : 0.f;
      }
    }
    __syncthreads();  // every thread is done with the buffer fetch_a refills
    if (step + 1 < steps) {
      fetch_a(step + 1, (step + 1) & 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this step's a has landed for every thread
    const float* as = abuf + (step & 1) * kBlk * kLd;
    for (int e = 0; e < d4; e += 4) {
      float4 av[4], sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = lds4(as + (rg + 16 * i) * kLd + e);
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = lds4(sS + (e + k) * kSlice + 4 * cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai[4] = {av[i].x, av[i].y, av[i].z, av[i].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[i][0] = fmaf(ai[k], sv[k].x, acc[i][0]);
          acc[i][1] = fmaf(ai[k], sv[k].y, acc[i][1]);
          acc[i][2] = fmaf(ai[k], sv[k].z, acc[i][2]);
          acc[i][3] = fmaf(ai[k], sv[k].w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = intra[i][j] + acc[i][j];  // o + a·S
      const int t = t0 + rg + 16 * i;
      if (t >= c || col >= d) continue;
      float* p = go + static_cast<int64_t>(t) * d + col;
      if (vec) {
        *reinterpret_cast<float4*>(p) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < d) p[j] = acc[i][j];
        }
      }
    }
    if (chunk_end) {  // S ← S ⊙ totᵀ + ΔS, once every row block has read S
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int i = tid + kStateThreads * q;
        sS[i] = sS[i] * dk[q] + ds[q];
      }
    }
  }
}

}  // namespace

// a, b, v, o: (bh, nc, c, d); tot: (bh, nc, 1, d); diag: (bh, nc, c, 1);
// dstate: a (bh, nc, d, d) workspace; float32, contiguous, o not aliasing an
// input.  1 <= d <= 64, 1 <= c <= 256, bh·nc < 2^31.  Launches the two
// kernels of the two-phase design on `stream`.
extern "C" int wkv_scan_launch(const void* a, const void* b, const void* v,
                               const void* tot, const void* diag, void* o,
                               void* dstate, int64_t bh, int64_t nc, int c, int d,
                               void* stream) {
  if (bh < 0 || nc < 0 || bh * nc > INT32_MAX || c < 1 || c > kMaxC || d < 1 ||
      d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bh == 0 || nc == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = raise_smem_limit(wkv_intra_kernel, kIntraSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  wkv_intra_kernel<<<static_cast<unsigned>(bh * nc), kIntraThreads, kIntraSmem, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(v), static_cast<const float*>(tot),
      static_cast<const float*>(diag), static_cast<float*>(o),
      static_cast<float*>(dstate), c, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slices = (d + kSlice - 1) / kSlice;
  wkv_state_kernel<<<static_cast<unsigned>(bh * n_slices), kStateThreads, kStateSmem, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(tot),
      static_cast<const float*>(dstate), static_cast<float*>(o),
      static_cast<int>(nc), c, d, n_slices);
  return static_cast<int>(cudaGetLastError());
}
