// Flash attention's causal forward for Hopper (sm_90a).
//
// Replaces no TPU kernel: repro/models/flash.py writes flash attention in
// plain jax.numpy, and the port's models/flash.py::_flash_fwd repeats it in
// plain torch over 512-blocks.  This kernel computes the same forward, in the
// same arithmetic:
//
//   s   = bf16(q · kᵀ)            the float32 sum rounded to the input type and
//                                 back, as the plain form's einsum-then-cast
//   m, l, o                        online softmax in float32 over 128-key tiles
//   p   = exp(s − m)              cast to the input type before p · v
//   o  += p · v                   accumulated in float32
//   out = type(o / l), lse = m + log(l)
//
// with the causal mask (key ≤ query).  q is pre-scaled by the caller.  Each
// (batch, head, 128-query tile) is one block and writes its rows alone, so a
// call repeats bit for bit.  The plain form rounds each 512-key block's p · v
// to the input type before adding it; here every tile's product goes into the
// float32 accumulator as it is.
//
// What bounds it on this card.  S·(S + 1)·(Dqk + Dv) operations a (batch,
// head) under the causal mask on the bf16 tensor cores (989 TFLOP/s dense)
// against S·(Dqk + Dv)·2 bytes of K/V and as many of q and out: at S = 2048
// and 4096 the operations bound it.  The softmax's exact expf and the bf16
// round trip of each score (about 14 instructions) take about as long as the
// products at D = 128, and every query tile streams its K/V from L2.
//
// Design.  One block of three warpgroups per (batch, head, query tile).  The
// (batch, head) rows go in chunks whose K/V fit in a share of L2 (the
// wrapper's chunk_rows), and a chunk's blocks are neighbours, longest causal
// rows first: in plain query-tile order the card would hold one tile of 132
// heads at once and read every K/V tile from HBM again.  The producer
// warpgroup lowers its registers (setmaxnreg) and one of its threads loads q
// once and then K and V tiles of 128 keys into a two-stage ring by TMA (4-d
// tensor maps over strided (B, H, S, D) views, 128-byte swizzle, zero fill
// past S), each guarded by its own full and empty mbarriers.  Query head h reads KV head h / (H / H_kv):
// grouped heads share K/V by index, with no copy.  Two consumer warpgroups
// each own 64 query rows:
//   * S = q · kᵀ on wgmma m64n128k16 with both operands in shared memory,
//     K-major as they lie in memory;
//   * the online softmax in registers (each row over 4 threads, shuffles for
//     its max and sum); tiles wholly above the diagonal are never loaded, the
//     diagonal tile is masked;
//   * o += p · v on wgmma with p as the register A operand (the score
//     accumulator's layout is the A fragment's, packed two to a register) and
//     v read MN-major through wgmma's transpose flag, with no transposed copy;
//   * tile kt's scores are issued with tile kt − 1's p · v, so that the
//     tensor cores work on the product while the softmax of kt runs.
// The epilogue divides by l, rounds to the input type and stores out and lse
// straight from registers.
//
// Head dims are template parameters; (Dqk, Dv) = (128, 128) and (192, 128)
// are built, in bf16 and fp16.  Interface: a plain C entry point (bound with
// ctypes), launching on the caller's stream, allocating nothing and returning
// a cudaError_t code.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;       // query rows a block
constexpr int kBlockN = 128;       // keys a K/V tile
constexpr int kStages = 2;         // K/V ring
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kBoxCols = 64;       // 16-bit elements in one 128-byte swizzle row
constexpr int kBoxBytes = 128 * 128;  // one TMA box: 128 rows × 128 bytes

template <int DQK, int DV>
struct Layout {
  static constexpr int kQBytes = DQK / kBoxCols * kBoxBytes;
  static constexpr int kKBytes = DQK / kBoxCols * kBoxBytes;
  static constexpr int kVBytes = DV / kBoxCols * kBoxBytes;
  static constexpr int kBarOffset = kQBytes + kStages * (kKBytes + kVBytes);
  static constexpr int kBars = 1 + 4 * kStages;  // q; k/v full and empty per stage
  static constexpr int kSmem = kBarOffset + 8 * kBars + 1024;  // + alignment slack
};

// Pins registers at this point of the program: the compiler moves no read
// or write of them across it, and so none across the wgmma wait before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[t][i])::"memory");
  }
}

#define FA_D64                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),           \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),           \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),           \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),           \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),           \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),           \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),           \
      "+f"(d[62]), "+f"(d[63])

#define FA_R64                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "             \
  "%8, %9, %10, %11, %12, %13, %14, %15, "        \
  "%16, %17, %18, %19, %20, %21, %22, %23, "      \
  "%24, %25, %26, %27, %28, %29, %30, %31, "      \
  "%32, %33, %34, %35, %36, %37, %38, %39, "      \
  "%40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, "      \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "

// D (64×128, float32) = [D +] A (64×16, shared, K-major) · B (128×16, shared,
// K-major)ᵀ; `acc` 0 overwrites D
#define FA_WGMMA_SS(TY)                                                         \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " FA_R64 \
               "%64, %65, p, 1, 1, 0, 0;\n}\n"                                  \
               : FA_D64                                                         \
               : "l"(da), "l"(db), "r"(acc))

// D (64×128, float32) += A (64×16, registers) · B (16×128, shared, MN-major)
#define FA_WGMMA_RS(TY)                                                         \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"                   \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " FA_R64 \
               "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                    \
               : FA_D64                                                         \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <bool kHalf>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  if constexpr (kHalf) {
    FA_WGMMA_SS("f16");
  } else {
    FA_WGMMA_SS("bf16");
  }
}

template <bool kHalf>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kHalf) {
    FA_WGMMA_RS("f16");
  } else {
    FA_WGMMA_RS("bf16");
  }
}

// x0 and x1 rounded to the input type (to nearest) and back
template <bool kHalf>
__device__ __forceinline__ void round_input(float& x0, float& x1) {
  if constexpr (kHalf) {
    const float2 r = __half22float2(__floats2half2_rn(x0, x1));
    x0 = r.x;
    x1 = r.y;
  } else {
    const float2 r = __bfloat1622float2(__floats2bfloat162_rn(x0, x1));
    x0 = r.x;
    x1 = r.y;
  }
}

// (lo, hi) rounded to the input type, lo in the low half
template <bool kHalf>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

struct Strides {
  long long b, h, s;  // elements; the last dim is contiguous
};

// Accumulator fragment of a consumer thread (64×128 float32 over a
// warpgroup): register 4j + 2h + e holds row 16·warp + lane/4 + 8h, column
// 8j + 2·(lane % 4) + e.  The A fragment of k-step t (columns 16t..16t+15) is
// registers 8t..8t+7 of the same layout, two to a 32-bit register.
template <int DQK, int DV, bool kHalf>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, uint16_t* __restrict__ out,
                 float* __restrict__ lse, int H, int group, int S, int chunk_rows) {
  using L = Layout<DQK, DV>;
  constexpr int kQBoxes = DQK / kBoxCols;
  constexpr int kVBoxes = DV / kBoxCols;
  static_assert(DV == 128, "one m64n128 product covers the value width");
  static_assert(DQK % kBoxCols == 0, "Dqk is a multiple of 64");

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle atom
  const uint32_t q_smem = base;
  const uint32_t k_smem = base + L::kQBytes;
  const uint32_t v_smem = k_smem + kStages * L::kKBytes;
  const uint32_t q_bar = base + L::kBarOffset;
  const uint32_t kfull0 = q_bar + 8;
  const uint32_t vfull0 = kfull0 + 8 * kStages;
  const uint32_t kempty0 = vfull0 + 8 * kStages;
  const uint32_t vempty0 = kempty0 + 8 * kStages;

  // The (batch, head) rows go in chunks of `chunk_rows`, and a chunk's
  // blocks are neighbours, longest causal rows first: the blocks on the card
  // at once read the K/V of a chunk, which stays in L2.
  const int n_qt = (S + kBlockM - 1) / kBlockM;
  const int rows = static_cast<int>(gridDim.x) / n_qt;
  const int chunk = static_cast<int>(blockIdx.x) / (chunk_rows * n_qt);
  const int in_chunk = static_cast<int>(blockIdx.x) - chunk * chunk_rows * n_qt;
  const int chunk_size = min(chunk_rows, rows - chunk * chunk_rows);
  const int qt = n_qt - 1 - in_chunk / chunk_size;
  const int bh = chunk * chunk_rows + in_chunk % chunk_size;
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / group;
  const int q0 = qt * kBlockM;
  const int n_kv = qt + 1;  // key tiles at or below the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
      mbar_init(kempty0 + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(vempty0 + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ---------------------------------------------------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, L::kQBytes);
#pragma unroll
      for (int c = 0; c < kQBoxes; ++c) {
        tma_load_4d(q_smem + c * kBoxBytes, &map_q, q_bar, c * kBoxCols, q0, h, b);
      }
      for (int kt = 0; kt < n_kv; ++kt) {
        const int st = kt % kStages;
        const uint32_t ph = (kt / kStages) & 1;
        const uint32_t kf = kfull0 + 8 * st;
        const uint32_t vf = vfull0 + 8 * st;
        mbar_wait(kempty0 + 8 * st, ph ^ 1);
        mbar_expect_tx(kf, L::kKBytes);
#pragma unroll
        for (int c = 0; c < kQBoxes; ++c) {
          tma_load_4d(k_smem + st * L::kKBytes + c * kBoxBytes, &map_k, kf,
                      c * kBoxCols, kt * kBlockN, hk, b);
        }
        mbar_wait(vempty0 + 8 * st, ph ^ 1);
        mbar_expect_tx(vf, L::kVBytes);
#pragma unroll
        for (int c = 0; c < kVBoxes; ++c) {
          tma_load_4d(v_smem + st * L::kVBytes + c * kBoxBytes, &map_v, vf,
                      c * kBoxCols, kt * kBlockN, hk, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns query rows [64·cw, 64·cw + 64) --------
  setmaxnreg_inc<232>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x - 128 * wg;
  const int warp = t128 >> 5;
  const int lane = t128 & 31;
  const int row_in_tile = 64 * cw + 16 * warp + (lane >> 2);  // + 8h
  const int col_in_tile = 2 * (lane & 3);                     // + 8j + e

  // S = q · kᵀ of key tile kt, issued (not waited for)
  auto issue_qk = [&](float (&s)[64], int kt) {
    const int st = kt % kStages;
    mbar_wait(kfull0 + 8 * st, (kt / kStages) & 1);
    const uint32_t kb = k_smem + st * L::kKBytes;
#pragma unroll
    for (int c = 0; c < kQBoxes; ++c) {
      const uint64_t da = desc_k_major(q_smem + c * kBoxBytes + cw * (64 * 128));
      const uint64_t db = desc_k_major(kb + c * kBoxBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 elements = 32 bytes a step
        wgmma_ss<kHalf>(s, da + 2 * kk, db + 2 * kk, c + kk > 0);
      }
    }
    wgmma_commit();
  };
  // o += p · v of key tile kt, p in the input type as the register operand
  auto issue_pv = [&](float (&o)[64], const uint32_t (&pa)[8][4], int kt) {
    const int st = kt % kStages;
    mbar_wait(vfull0 + 8 * st, (kt / kStages) & 1);
    const uint32_t vb = v_smem + st * L::kVBytes;
#pragma unroll
    // v is MN-major (rows are keys): its next 64 columns lie one box on
    for (int t = 0; t < 8; ++t) {  // 16 keys = 2 atoms of 8 a step
      wgmma_rs<kHalf>(o, pa[t], desc_mn_major(vb + t * 2048, kBoxBytes));
    }
    wgmma_commit();
  };
  auto release = [&](uint32_t empty0, int kt) {
    if (lane == 0) mbar_arrive(empty0 + 8 * (kt % kStages));
  };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float corr[2];
  // the online softmax of tile kt in place (scores in, probabilities out);
  // each row lies on the 4 threads of a quad
  auto softmax = [&](float (&s)[64], int kt) {
#pragma unroll
    for (int i = 0; i < 64; i += 2) round_input<kHalf>(s[i], s[i + 1]);  // logits in the input type
    if (kt == qt) {  // the diagonal tile: key > query is masked
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (col_in_tile + 8 * j + e > row_in_tile + 8 * hh) s[4 * j + 2 * hh + e] = -INFINITY;
          }
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[hh] = expf(m[hh] - mx);
      m[hh] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[4 * j + 2 * hh + e] - mx);
          s[4 * j + 2 * hh + e] = p;
          sum += p;
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hh] = l[hh] * corr[hh] + sum;
    }
  };
  auto pack = [&](uint32_t (&pa)[8][4], const float (&s)[64]) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[t][r] = pack2<kHalf>(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
      }
    }
  };

  // Tile kt's scores are taken while tile kt − 1's p · v runs: per step,
  //   issue S(kt) and O += P(kt−1)·V(kt−1); wait for S(kt); its softmax;
  //   wait for the product; O *= corr(kt); P(kt).
  // O sees the plain form's sequence: (O + P·V) · corr, then + P·V.
  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float s[64];
  uint32_t pa[8][4];
  mbar_wait(q_bar, 0);
  wgmma_fence();
  issue_qk(s, 0);
  wgmma_wait<0>();
  fence_regs(s);
  release(kempty0, 0);
  softmax(s, 0);
  pack(pa, s);
  for (int kt = 1; kt < n_kv; ++kt) {
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
    issue_qk(s, kt);
    issue_pv(o, pa, kt - 1);
    wgmma_wait<1>();  // S(kt) is in
    fence_regs(s);
    release(kempty0, kt);
    softmax(s, kt);
    wgmma_wait<0>();  // so is O
    fence_regs(o);
    release(vempty0, kt - 1);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j + 0] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    pack(pa, s);
  }
  fence_regs(o);
  fence_regs(pa);
  wgmma_fence();
  issue_pv(o, pa, n_kv - 1);
  wgmma_wait<0>();
  fence_regs(o);
  release(vempty0, n_kv - 1);

  // epilogue: out = o / l in the input type, lse = m + log(l)
  const size_t row_base = (static_cast<size_t>(b) * H + h) * S;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + row_in_tile + 8 * hh;
    if (row >= S) continue;
    const float lv = fmaxf(l[hh], 1e-30f);
    uint32_t* orow = reinterpret_cast<uint32_t*>(out + (row_base + row) * DV);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      orow[(8 * j + col_in_tile) / 2] =
          pack2<kHalf>(o[4 * j + 2 * hh] / lv, o[4 * j + 2 * hh + 1] / lv);
    }
    if ((lane & 3) == 0) lse[row_base + row] = m[hh] + logf(lv);
  }
}

// A (B, heads, S, D) view with D contiguous as a (D, S, heads, B) tensor map,
// read in boxes of 64 columns (128 bytes) × 128 rows with 128-byte swizzle;
// loads past S are zero-filled.
bool encode_map(EncodeTiled encode, CUtensorMap* map, bool half, const void* ptr, int B,
                int heads, int S, int D, Strides st) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {kBoxCols, kBlockN, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map,
                half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DQK, int DV, bool kHalf>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, void* out,
           void* lse, int B, int H, int group, int S, int chunk_rows, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<DQK, DV, kHalf>;
  constexpr int smem = Layout<DQK, DV>::kSmem;
  const cudaError_t err = raise_smem_limit(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid =
      static_cast<long long>((S + kBlockM - 1) / kBlockM) * B * H;
  if (grid > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<uint16_t*>(out), static_cast<float*>(lse), H, group, S,
      chunk_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, H, S, Dqk), k (B, H_kv, S, Dqk), v (B, H_kv, S, Dv): strided views
// with the last dim contiguous, strides in elements (multiples of 8) and
// 16-byte aligned pointers, bf16 (half = 0) or fp16 (half = 1), q pre-scaled;
// H % H_kv == 0.  out (B, H, S, Dv) in the input type and lse (B, H, S)
// float32, both contiguous, must not alias the inputs.  (Dqk, Dv) is
// (128, 128) or (192, 128).  The blocks walk the B·H (batch, head) rows in
// chunks of `chunk_rows` (≥ 1), longest causal rows first within a chunk.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
    int H_kv, int S, int dqk, int dv, int half, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, int chunk_rows, void* stream) {
  if (B <= 0 || H <= 0 || H_kv <= 0 || S <= 0 || H % H_kv != 0 || chunk_rows < 1 ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long strides[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  for (long long st : strides) {
    if (st <= 0 || st % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap mq, mk, mv;
  const bool h16 = half != 0;
  if (!encode_map(encode, &mq, h16, q, B, H, S, dqk, {q_sb, q_sh, q_ss}) ||
      !encode_map(encode, &mk, h16, k, B, H_kv, S, dqk, {k_sb, k_sh, k_ss}) ||
      !encode_map(encode, &mv, h16, v, B, H_kv, S, dv, {v_sb, v_sh, v_ss})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int group = H / H_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dqk == 128 && dv == 128) {
    return h16 ? launch<128, 128, true>(mq, mk, mv, out, lse, B, H, group, S, chunk_rows, st)
               : launch<128, 128, false>(mq, mk, mv, out, lse, B, H, group, S, chunk_rows, st);
  }
  if (dqk == 192 && dv == 128) {
    return h16 ? launch<192, 128, true>(mq, mk, mv, out, lse, B, H, group, S, chunk_rows, st)
               : launch<192, 128, false>(mq, mk, mv, out, lse, B, H, group, S, chunk_rows, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
