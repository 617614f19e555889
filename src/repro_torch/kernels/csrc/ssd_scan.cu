// Mamba-2 SSD chunk scan for Hopper (sm_90a): the grouped SSD of a prefill
// in float32 accuracy, each head's state kept on chip from one chunk to the
// next.
//
// Replaces no TPU kernel: repro/models/ssm.py's chunked SSD is plain
// jax.numpy, and the port's plain form (models/ssm.py::ssd_grouped, one
// _ssd_chunked per B/C group) writes (chunks, B, H, 64, 64) float32 decays
// and scores to device memory, passes over them several times, and carries
// the state in a Python loop of two launches a chunk.  This kernel computes
// the same y and final state in one launch.  For every (row, head) and
// every chunk of kL positions in order, with the state S (P × N) starting
// at zero and a < 0 the head's decay:
//
//   cum_t   = Σ_{j ≤ t} dt_j·a                  (within the chunk)
//   y_t     = Σ_{i ≤ t} (C_t·B_i)·exp(cum_t − cum_i)·dt_i·x_i
//             + exp(cum_t)·(S·C_t)
//   S      ← exp(cum_end)·S + Σ_i exp(cum_end − cum_i)·dt_i·(x_i ⊗ B_i)
//
// B and C are the head's group's; positions past T have dt = 0, x = B = C
// = 0 and leave S as it is.  exp(cum_end − cum_i) is taken from the sum of
// the log-decays after i (a suffix scan), not from a difference of prefix
// sums, so the last positions, which weigh most in S, keep exact exponents.
//
// What bounds it on this card.  Per position and head the products cost
// about 2·(kL/2)·P (scores against x) + 2·N·P (S against C) + 2·N·P (the
// state update) FLOP, and per position and group 2·kL·N (C against B): at
// Zamba2-7B's P = N = 64, kL = 64, 112 heads in 2 groups, 4 × 4096
// positions, 4.4e10 FLOP a layer.  Its bytes (x, B, C in bf16, dt, y in
// float32, the final state) are 0.72 GB, 0.21 ms at 3.35 TB/s.  At the
// 67 TFLOP/s of float32 FMAs the products alone take 0.66 ms, and a first
// design on the CUDA cores (4 × 4 register tiles, bound by shared-memory
// loads) reached 18 TFLOP/s.  So the products run on the tensor cores as
// split products in float32 accuracy ("3×TF32"): each float32 operand is
// the sum of a TF32 high part and a TF32 low part, and a·b = a_lo·b_hi +
// a_hi·b_lo + a_hi·b_hi, accumulated in float32 (a_lo·b_lo, under 2^-20 of
// the product, is left out).  Plain TF32 or bf16 operands would hold 3
// decimal digits; the split holds float32's.
//
// Design.  One block of 512 threads takes up to kMaxHb heads of one
// (row, group) — the wrapper chooses how many, so that the blocks fill the
// card — and walks that row's chunks in order.  Its 16 warps form 4 teams
// of 4; team h takes head h of the block, warp w of a team the state rows
// p ∈ [16w, 16w + 16).  A warp keeps its 16 × N slice of S in registers,
// as the accumulators of m16n8k8 mma.sync tiles, for the whole sequence:
// nothing per chunk leaves the SM.  Per chunk:
//   1. B, C (kL × N), dt (hb × kL) and x (hb × kL × P) are read once from
//      device memory at their own strides (a stride-0 group included), each
//      thread issuing all its loads before its first store, and converted
//      exactly to float32 in shared memory: C split into high and low parts
//      as (t, n), B split and transposed as (n, i) — every warp of the
//      block reads them, so they are split once — and x transposed as
//      (p, i) per head; 16-byte loads where the rows allow.
//   2. One warp per head takes the chunk's log-decay scans and exp(cum_t),
//      exp(cum_end − cum_i)·dt_i, exp(cum_end); the 16 warps take C·Bᵀ once
//      for all heads of the block (a 16 × 16 tile each, the 6 tiles above
//      the diagonal skipped), and each warp writes every head's masked
//      scores (C·Bᵀ)·exp(cum_t − cum_i)·dt_i on its tile.
//   3. Each warp computes its rows of yᵀ (p × t): its S slice, as the A
//      operand straight from the accumulator registers, times Cᵀ, scaled
//      by exp(cum_t), plus xᵀ times the scores (causal: a tile of 8
//      positions reads the key tiles up to its own), writes y, scales S by
//      exp(cum_end) and adds (x ⊙ exp(cum_end − cum_i)·dt_i)ᵀ·B.
// Within each k-slice of 8 the fragments take k in the order 2κ, 2κ + 1
// (κ the fragment's own index), so that a thread's two k values are
// adjacent: the accumulator fragment of S is then exactly the A fragment
// S·Cᵀ needs, and the other operands load as 8-byte pairs from tiles whose
// rows are padded to 72 floats (no bank conflicts).
//
// At the Zamba2-7B prefill (B = 4, T = 4096, 2 groups of 56 heads) the
// wrapper takes 4 heads a block: 112 blocks of 225,296 B of shared memory,
// one an SM.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kL = 64;           // positions a chunk
constexpr int kMaxP = 64;        // head dim
constexpr int kMaxN = 64;        // state size
constexpr int kMaxHb = 4;        // heads a block: one a team
constexpr int kWarps = 16;       // 4 teams of 4
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kL + 8;      // a padded tile row, in floats
constexpr int kTile = kL * kLd;  // a 64-row tile, in floats

struct Params {
  const void* x;    // (B, T, H, P)
  const void* b;    // (B, T, G, N)
  const void* c;    // (B, T, G, N)
  const float* dt;  // (B, T, H)
  const float* a;   // (H,)
  float* y;         // (B, T, H, P), contiguous
  float* state;     // (B, H, P, N), contiguous
  int64_t sx[4], sb[4], sc[4], sdt[3], sa;  // strides, in elements
  int t_len, heads, groups, p, n, hb, tiles, vec_x, vec_bc;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ uint2 lds2u(const float* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// A float32 value as the sum of two TF32 values: hi keeps the sign, the
// exponent and the top 10 bits of the significand (the rest cleared), and
// lo = x − hi is exact; the tensor cores read lo's top 10 bits, which
// leaves out less than 2^-20 of x.
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 × 8): (row g, k 2κ), (row g + 8, k 2κ), (row g,
// k 2κ + 1), (row g + 8, k 2κ + 1); a B fragment (8 × 8): (k 2κ, col g),
// (k 2κ + 1, col g).  Each split into high and low parts.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2, float a3) {
  const Split s0 = split(a0), s1 = split(a1), s2 = split(a2), s3 = split(a3);
  return {{s0.hi, s1.hi, s2.hi, s3.hi}, {s0.lo, s1.lo, s2.lo, s3.lo}};
}
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}
// a B fragment whose two k values lie side by side in split tiles
__device__ __forceinline__ FragB frag_b(const float* hi, const float* lo) {
  const uint2 h = lds2u(hi), l = lds2u(lo);
  return {{h.x, h.y}, {l.x, l.y}};
}

// d += a·b in float32 accuracy: the small products first.
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

// Element j of a 16-byte vector of T.
template <typename T>
__device__ __forceinline__ float elem(const uint4& raw, int j) {
  return to_float(reinterpret_cast<const T*>(&raw)[j]);
}

// The chunk's operands into shared memory, converted exactly to float32:
// C split as csh/csl[t][n], B split and transposed as bth/btl[n][i], dt as
// dts[h][i] and x transposed as xt[h][p][i] (zeros past the chunk, the
// state size and the group's heads).  Each thread issues all its loads
// before its first store.  A warp's lanes take 32 consecutive positions,
// so that the transposed stores fall in distinct banks.
template <typename T>
__device__ __forceinline__ void load_chunk(const Params& pr, float* csh, float* csl, float* bth,
                                           float* btl, float* dts, float* xt, int64_t bi,
                                           int grp, int head0, int nh, int t0, int lt,
                                           int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kBc = kL * kMaxN / kVec / kThreads;           // vectors a thread
  constexpr int kX = kL * kMaxHb * kMaxP / kVec / kThreads;   // vectors a thread
  const int hb = pr.hb, np = pr.p, nn = pr.n;
  const T* bp = static_cast<const T*>(pr.b) + bi * pr.sb[0] + grp * pr.sb[2];
  const T* cp = static_cast<const T*>(pr.c) + bi * pr.sc[0] + grp * pr.sc[2];
  const T* xp = static_cast<const T*>(pr.x) + bi * pr.sx[0] + head0 * pr.sx[2];
  const float* dtp = pr.dt + bi * pr.sdt[0] + head0 * pr.sdt[2];
  const uint4 zero = make_uint4(0, 0, 0, 0);

  uint4 braw[kBc], craw[kBc], xraw[kX];
  if (pr.vec_bc) {
#pragma unroll
    for (int r = 0; r < kBc; ++r) {
      const int e = tid + r * kThreads, i = e & (kL - 1), q = e / kL;
      const bool ok = i < lt && q * kVec < nn;
      const int64_t t = t0 + i;
      braw[r] = ok ? __ldg(reinterpret_cast<const uint4*>(bp + t * pr.sb[1] + q * kVec)) : zero;
      craw[r] = ok ? __ldg(reinterpret_cast<const uint4*>(cp + t * pr.sc[1] + q * kVec)) : zero;
    }
  }
  if (pr.vec_x) {
    const int vpr = np / kVec;
#pragma unroll
    for (int r = 0; r < kX; ++r) {
      const int e = tid + r * kThreads, i = e & (kL - 1);
      const int q = (e / kL) % vpr, h = e / (kL * vpr);
      const bool ok = i < lt && h < nh;
      xraw[r] = ok ? __ldg(reinterpret_cast<const uint4*>(
                         xp + (t0 + i) * pr.sx[1] + h * pr.sx[2] + q * kVec))
                   : zero;
    }
  }
  float dtv = 0.f;
  if (tid < hb * kL) {
    const int h = tid / kL, i = tid & (kL - 1);
    if (i < lt && h < nh) dtv = dtp[(t0 + i) * pr.sdt[1] + h * pr.sdt[2]];
  }

  if (pr.vec_bc) {
#pragma unroll
    for (int r = 0; r < kBc; ++r) {
      const int e = tid + r * kThreads, i = e & (kL - 1), q = e / kL;
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        float4 ch, cl;
        float* const chv = &ch.x;
        float* const clv = &cl.x;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = q * kVec + j + u;
          const Split sb = split(elem<T>(braw[r], j + u)), sc = split(elem<T>(craw[r], j + u));
          bth[k * kLd + i] = __uint_as_float(sb.hi);
          btl[k * kLd + i] = __uint_as_float(sb.lo);
          chv[u] = __uint_as_float(sc.hi);
          clv[u] = __uint_as_float(sc.lo);
        }
        *reinterpret_cast<float4*>(csh + i * kLd + q * kVec + j) = ch;
        *reinterpret_cast<float4*>(csl + i * kLd + q * kVec + j) = cl;
      }
    }
  } else {
    for (int e = tid; e < kL * kMaxN; e += kThreads) {
      const int i = e & (kL - 1), k = e / kL;
      float bv = 0.f, cv = 0.f;
      if (i < lt && k < nn) {
        const int64_t t = t0 + i;
        bv = to_float(bp[t * pr.sb[1] + k * pr.sb[3]]);
        cv = to_float(cp[t * pr.sc[1] + k * pr.sc[3]]);
      }
      const Split sb = split(bv), sc = split(cv);
      bth[k * kLd + i] = __uint_as_float(sb.hi);
      btl[k * kLd + i] = __uint_as_float(sb.lo);
      csh[i * kLd + k] = __uint_as_float(sc.hi);
      csl[i * kLd + k] = __uint_as_float(sc.lo);
    }
  }
  if (pr.vec_x) {
    const int vpr = np / kVec;
#pragma unroll
    for (int r = 0; r < kX; ++r) {
      const int e = tid + r * kThreads, i = e & (kL - 1);
      const int q = (e / kL) % vpr, h = e / (kL * vpr);
      if (h >= hb) continue;
      float* dst = xt + h * kTile + q * kVec * kLd + i;
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[j * kLd] = elem<T>(xraw[r], j);
    }
  } else {
    for (int e = tid; e < kL * hb * np; e += kThreads) {
      const int i = e & (kL - 1), p = (e / kL) % np, h = e / (kL * np);
      float v = 0.f;
      if (i < lt && h < nh) v = to_float(xp[(t0 + i) * pr.sx[1] + h * pr.sx[2] + p * pr.sx[3]]);
      xt[h * kTile + p * kLd + i] = v;
    }
  }
  if (tid < hb * kL) dts[tid] = dtv;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(const Params pr) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int hb = pr.hb;
  float* const csh = smem;             // csh/csl[t][n]: the chunk's C, split
  float* const csl = csh + kTile;
  float* const bth = csl + kTile;      // bth/btl[n][i]: its B, split, transposed
  float* const btl = bth + kTile;
  float* const sc = btl + kTile;       // sc[h][t][i]: each head's masked scores
  float* const xt = sc + hb * kTile;   // xt[h][p][i]: each head's x, transposed
  float* const cum = xt + hb * kTile;  // cum[h][t]
  float* const ecum = cum + hb * kL;   // exp(cum_t)
  float* const wend = ecum + hb * kL;  // exp(cum_end − cum_i)·dt_i
  float* const dts = wend + hb * kL;   // dt_i
  float* const etot = dts + hb * kL;   // exp(cum_end), one a head

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, kq = lane & 3;  // the fragments' row group and κ
  const int team = warp >> 2;              // the block's head it takes
  const int p0 = 16 * (warp & 3);          // its warp's state rows p0 … p0 + 15
  const int tile = blockIdx.x % pr.tiles;
  const int grp = (blockIdx.x / pr.tiles) % pr.groups;
  const int64_t bi = blockIdx.x / (pr.tiles * pr.groups);
  const int per = pr.heads / pr.groups;
  const int nh = min(hb, per - tile * hb);
  const int head0 = grp * per + tile * hb;
  const int np = pr.p, nn = pr.n, t_len = pr.t_len;
  const int n_sl = (nn + 7) >> 3;  // k-slices of 8 over the state
  const bool active = team < nh && p0 < np;

  for (int e = tid; e < (4 + 2 * hb) * kTile; e += kThreads) smem[e] = 0.f;

  // the warp's slice of S: n-tile j holds (p0 + g, 8j + 2κ), (p0 + g, 8j + 2κ + 1),
  // (p0 + g + 8, 8j + 2κ), (p0 + g + 8, 8j + 2κ + 1)
  float s[8][4] = {};

  const int n_chunks = (t_len + kL - 1) / kL;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int t0 = ch * kL;
    const int lt = min(kL, t_len - t0);  // positions of this chunk
    const int n_tt = (lt + 7) >> 3;      // position tiles of 8
    __syncthreads();  // the previous chunk's tiles are no longer read

    // 1. the chunk's operands
    load_chunk<T>(pr, csh, csl, bth, btl, dts, xt, bi, grp, head0, nh, t0, lt, tid);
    __syncthreads();

    // 2. the decays, one warp a head (lane: positions 2·lane, 2·lane + 1)
    if (warp < nh) {
      const float ah = pr.a[(head0 + warp) * pr.sa];
      const int o = warp * kL + 2 * lane;
      const float d0 = dts[o], d1 = dts[o + 1];
      const float v0 = d0 * ah, v1 = d1 * ah;
      const float pair = v0 + v1;
      float incl = pair, sinc = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        const float down = __shfl_down_sync(0xffffffffu, sinc, off);
        if (lane >= off) incl += up;
        if (lane + off < 32) sinc += down;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      float sexc = __shfl_down_sync(0xffffffffu, sinc, 1);
      const float total = __shfl_sync(0xffffffffu, sinc, 0);
      if (lane == 0) excl = 0.f;
      if (lane == 31) sexc = 0.f;
      const float c0 = excl + v0;
      const float c1 = c0 + v1;
      cum[o] = c0;
      cum[o + 1] = c1;
      ecum[o] = expf(c0);
      ecum[o + 1] = expf(c1);
      wend[o] = expf(sexc + v1) * d0;
      wend[o + 1] = expf(sexc) * d1;
      if (lane == 0) etot[warp] = expf(total);
    }
    // C·Bᵀ: warp w the rows r0 = 16(w / 4) …, the columns c0 = 16(w % 4) …;
    // a tile above the diagonal is masked out, and its scores stay as the
    // first chunk left them: zeros
    const int r0 = 16 * (warp >> 2), c0 = 16 * (warp & 3);
    const bool below = c0 <= r0;
    float cb[2][4] = {};
    for (int ks = 0; below && ks < n_sl; ++ks) {
      const int k = 8 * ks + 2 * kq;
      const int lo = (r0 + g) * kLd + k, hi = lo + 8 * kLd;
      const uint2 ah0 = lds2u(csh + lo), al0 = lds2u(csl + lo);
      const uint2 ah1 = lds2u(csh + hi), al1 = lds2u(csl + hi);
      const FragA fa = {{ah0.x, ah1.x, ah0.y, ah1.y}, {al0.x, al1.x, al0.y, al1.y}};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = k * kLd + c0 + 8 * j + g;
        const FragB fb = {{__float_as_uint(bth[o]), __float_as_uint(bth[o + kLd])},
                          {__float_as_uint(btl[o]), __float_as_uint(btl[o + kLd])}};
        mma3(cb[j], fa, fb);
      }
    }
    __syncthreads();

    // 3. every head's masked scores from this warp's tile of C·Bᵀ
    for (int h = 0; below && h < nh; ++h) {
      const float* cumh = cum + h * kL;
      const float* dth = dts + h * kL;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = c0 + 8 * j + 2 * kq;
        const float2 ci = lds2(cumh + i), di = lds2(dth + i);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = r0 + g + 8 * half;
          const float ct = cumh[t];
          float2 v;
          v.x = i <= t ? (cb[j][2 * half] * expf(ct - ci.x)) * di.x : 0.f;
          v.y = i + 1 <= t ? (cb[j][2 * half + 1] * expf(ct - ci.y)) * di.y : 0.f;
          *reinterpret_cast<float2*>(sc + h * kTile + t * kLd + i) = v;
        }
      }
    }
    __syncthreads();
    if (!active) continue;

    // 4. this warp's rows of yᵀ = exp(cum_t) ⊙ (S·Cᵀ) + xᵀ·scoresᵀ, in
    // position tiles of 8 …
    const int h = team;
    const float* xth = xt + h * kTile;
    const float* sch = sc + h * kTile;
    float acc[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= n_sl) break;
      const FragA fa = frag_a(s[j][0], s[j][2], s[j][1], s[j][3]);
      const int k = 8 * j + 2 * kq;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (jj >= n_tt) break;
        const int o = (8 * jj + g) * kLd + k;
        mma3(acc[jj], fa, frag_b(csh + o, csl + o));
      }
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 e = lds2(ecum + h * kL + 8 * jj + 2 * kq);
      acc[jj][0] *= e.x;
      acc[jj][1] *= e.y;
      acc[jj][2] *= e.x;
      acc[jj][3] *= e.y;
    }
    // … and, over the same key tiles, the state update: S is scaled by
    // exp(cum_end) now and takes each tile's increment
    const float et = etot[h];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] *= et;
      s[j][1] *= et;
      s[j][2] *= et;
      s[j][3] *= et;
    }
    const float* wh = wend + h * kL;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks >= n_tt) break;
      const int k = 8 * ks + 2 * kq;
      const float2 xlo = lds2(xth + (p0 + g) * kLd + k);
      const float2 xhi = lds2(xth + (p0 + g + 8) * kLd + k);
      const FragA fx = frag_a(xlo.x, xhi.x, xlo.y, xhi.y);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (jj < ks || jj >= n_tt) continue;
        const float2 sv = lds2(sch + (8 * jj + g) * kLd + k);
        mma3(acc[jj], fx, frag_b(sv.x, sv.y));
      }
      const float2 w = lds2(wh + k);
      const FragA fw = frag_a(xlo.x * w.x, xhi.x * w.x, xlo.y * w.y, xhi.y * w.y);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= n_sl) break;
        const int o = (8 * j + g) * kLd + k;
        mma3(s[j], fw, frag_b(bth + o, btl + o));
      }
    }
    // y at positions t0 + 8jj + 2κ (+1), rows p0 + g (+8)
    const int pa = p0 + g, pb = p0 + g + 8;
    float* yh = pr.y + ((bi * t_len + t0) * pr.heads + head0 + h) * np;
    const int64_t row = static_cast<int64_t>(pr.heads) * np;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int t = 8 * jj + 2 * kq;
      if (t < lt) {
        if (pa < np) yh[t * row + pa] = acc[jj][0];
        if (pb < np) yh[t * row + pb] = acc[jj][2];
      }
      if (t + 1 < lt) {
        if (pa < np) yh[(t + 1) * row + pa] = acc[jj][1];
        if (pb < np) yh[(t + 1) * row + pb] = acc[jj][3];
      }
    }
  }

  // the final states, (B, H, P, N)
  if (active) {
    float* sp = pr.state + (bi * pr.heads + head0 + team) * np * nn;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = 8 * j + 2 * kq;
      if (k < nn) {
        if (p0 + g < np) sp[(p0 + g) * nn + k] = s[j][0];
        if (p0 + g + 8 < np) sp[(p0 + g + 8) * nn + k] = s[j][2];
      }
      if (k + 1 < nn) {
        if (p0 + g < np) sp[(p0 + g) * nn + k + 1] = s[j][1];
        if (p0 + g + 8 < np) sp[(p0 + g + 8) * nn + k + 1] = s[j][3];
      }
    }
  }
}

constexpr int smem_bytes(int hb) {
  return ((4 + 2 * hb) * kTile + 4 * hb * kL + kMaxHb) * 4;
}

template <typename T>
bool aligned(const void* ptr, const int64_t* strides, int n_strides) {
  constexpr int kVec = 16 / sizeof(T);
  for (int i = 0; i < n_strides; ++i) {
    if (strides[i] % kVec != 0) return false;
  }
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
int launch(Params pr, int64_t batch, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  pr.vec_x = pr.sx[3] == 1 && pr.p % kVec == 0 && aligned<T>(pr.x, pr.sx, 3);
  pr.vec_bc = pr.sb[3] == 1 && pr.sc[3] == 1 && pr.n % kVec == 0 &&
              aligned<T>(pr.b, pr.sb, 3) && aligned<T>(pr.c, pr.sc, 3);
  const int smem = smem_bytes(pr.hb);
  cudaError_t err = raise_smem_limit(ssd_scan_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = batch * pr.groups * pr.tiles;
  ssd_scan_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(pr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, T, H, P) and b, c (B, T, G, N) in one type (dtype 0 bf16, 1 fp16,
// 2 fp32), dt (B, T, H) and a (H,) float32, each at the strides given (in
// elements; any, 0 included); y (B, T, H, P) and state (B, H, P, N)
// float32, contiguous, not aliasing an input.  H % G == 0, 1 <= P, N <= 64,
// 1 <= hb <= 4 heads a block.  Launches the kernel on `stream`.
extern "C" int ssd_scan_launch(const void* x, const void* b, const void* c, const void* dt,
                               const void* a, void* y, void* state, int64_t batch,
                               int64_t t_len, int64_t heads, int64_t groups, int64_t p,
                               int64_t n, int64_t sx0, int64_t sx1, int64_t sx2, int64_t sx3,
                               int64_t sb0, int64_t sb1, int64_t sb2, int64_t sb3, int64_t sc0,
                               int64_t sc1, int64_t sc2, int64_t sc3, int64_t sdt0,
                               int64_t sdt1, int64_t sdt2, int64_t sa, int dtype, int hb,
                               void* stream) {
  if (batch < 0 || t_len < 0 || t_len > INT32_MAX || heads < 1 || groups < 1 ||
      heads % groups != 0 || p < 1 || p > kMaxP || n < 1 || n > kMaxN || hb < 1 ||
      hb > kMaxHb) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (heads / groups + hb - 1) / hb;
  if (batch * groups * tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || t_len == 0) return static_cast<int>(cudaSuccess);
  Params pr{};
  pr.x = x;
  pr.b = b;
  pr.c = c;
  pr.dt = static_cast<const float*>(dt);
  pr.a = static_cast<const float*>(a);
  pr.y = static_cast<float*>(y);
  pr.state = static_cast<float*>(state);
  const int64_t sx[4] = {sx0, sx1, sx2, sx3}, sb[4] = {sb0, sb1, sb2, sb3},
                sc[4] = {sc0, sc1, sc2, sc3}, sdt[3] = {sdt0, sdt1, sdt2};
  for (int i = 0; i < 4; ++i) {
    pr.sx[i] = sx[i];
    pr.sb[i] = sb[i];
    pr.sc[i] = sc[i];
  }
  for (int i = 0; i < 3; ++i) pr.sdt[i] = sdt[i];
  pr.sa = sa;
  pr.t_len = static_cast<int>(t_len);
  pr.heads = static_cast<int>(heads);
  pr.groups = static_cast<int>(groups);
  pr.p = static_cast<int>(p);
  pr.n = static_cast<int>(n);
  pr.hb = hb;
  pr.tiles = static_cast<int>(tiles);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<__nv_bfloat16>(pr, batch, s);
    case 1: return launch<__half>(pr, batch, s);
    case 2: return launch<float>(pr, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
