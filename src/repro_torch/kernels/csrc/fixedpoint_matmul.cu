// W8A8 fixed-point GEMM for Hopper (sm_90a) — the paper's C1 datapath.
//
// Replaces repro/kernels/fixedpoint_matmul.py::fixedpoint_matmul_pallas and
// computes the same float32 values bit for bit:
//
//   acc[m,n] = sum_k x[m,k] * w[k,n]            int8 x int8, int32 accumulator
//   out[m,n] = (float(acc) * xs[m]) * ws[n]      round to nearest, in that order
//
// What bounds it on this card.  2·M·N·K operations on the int8 tensor cores
// (1,979 TOP/s dense) against M·K + K·N bytes in and 4·M·N out over
// 3.35 TB/s: at the 2048-token projections of the qwen2-1.5b layer the
// operations bound it; at one token (M = 1) the bytes of w do.
//
// Design (fixedpoint_matmul_wgmma_launch, every call): wgmma, for K % 16 == 0
//    and 16-byte aligned operands (the wrapper appends zero codes to K and
//    copies unaligned operands, which keeps the int32 sums).  w is taken K-major: the (K, N)
//    matrix with strides (1, K), i.e. an (N, K) row-major array, because wgmma
//    reads int8 operands only K-major.  A persistent grid (at most one block
//    per SM) walks units of work — a 128×128 output tile and one of `split`
//    slices of its K extent — in an order that keeps 8 row tiles side by side
//    for the L2.  Each block has three warpgroups.  The producer (one thread)
//    issues TMA loads (cp.async.bulk.tensor.2d, 128-byte swizzle) of the
//    128×128-byte x and w tiles into a ring of kStages shared-memory stages
//    guarded by full/empty mbarriers; it lowers its registers with setmaxnreg
//    and the consumers raise theirs.  Two consumer warpgroups each own 64 rows
//    of the tile and run wgmma.mma_async m64n128k32 s32.s8.s8 on the stages as
//    they arrive, with the int32 accumulators in registers, keeping one wgmma
//    group in flight while releasing the stage before it.  TMA zero-fills loads
//    past M, N and K.  The epilogue is __int2float_rn(acc) * xs[m], then *
//    ws[n], each rounded to nearest; each warpgroup writes its 64×128 float32
//    half-tile into shared memory (swizzled as the output's tensor map reads
//    it) and one thread issues TMA stores, which clip rows and columns past M
//    and N, so that the warpgroup starts its next tile while they drain (the
//    epilogue's global stores would otherwise take more time than the tile's
//    wgmmas at N = 8960); where N % 4 != 0 the threads store directly.  With
//    split > 1 each unit stores its int32 partial sums into a workspace (split,
//    M, N) and counts its arrival on its tile; the last slice of a tile to
//    arrive adds the other slices' sums to its own registers and runs the
//    epilogue (int32 sums are exact and associative, so the bits depend neither
//    on the split nor on the order of arrival; no block ever waits for
//    another).  The tensor maps are encoded on the host (hopper.cuh's
//    encode_tiled) and passed as __grid_constant__ parameters.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning a cudaError_t code.

#include <cstdint>
#include <mutex>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// wgmma + TMA, persistent, split-K
// ---------------------------------------------------------------------------

constexpr int kTile = 128;             // output tile rows and columns
constexpr int kTileK = 128;            // K bytes per stage: one 128-byte swizzle span
constexpr int kStages = 4;
constexpr int kStageBytes = 2 * kTile * kTileK;  // x tile + w tile
constexpr int kGroupM = 8;             // row tiles walked side by side
constexpr int kWgThreads = 384;        // producer + two consumer warpgroups
constexpr int kOutBytes = kTile * kTile * 4;    // the float32 output tile, staged
constexpr int kOutSlab = 32;                    // floats per 128-byte row of a store box
constexpr int kWgSmem = kStages * kStageBytes + kOutBytes + 2 * kStages * 8 + 16 + 1024;

// D (64×128, int32, accumulated) += A (64×32 int8, K-major) · B (128×32 int8, K-major)ᵀ
__device__ __forceinline__ void wgmma_m64n128k32(int32_t (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

struct Unit {
  int m0, n0, kb, ke, slice;
};

__device__ __forceinline__ Unit unit_of(int u, int split, int kper, int nk,
                                        int tiles_m, int tiles_n) {
  const int tile = u / split;
  const int slice = u - tile * split;
  const int per_group = kGroupM * tiles_n;
  const int group = tile / per_group;
  const int first_m = group * kGroupM;
  const int gsz = min(tiles_m - first_m, kGroupM);
  const int in_group = tile - group * per_group;
  Unit r;
  r.m0 = (first_m + in_group % gsz) * kTile;
  r.n0 = (in_group / gsz) * kTile;
  r.kb = slice * kper;
  r.ke = min(nk, r.kb + kper);
  r.slice = slice;
  return r;
}

__global__ void __launch_bounds__(kWgThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_out, int tma_out,
                  const float* __restrict__ xs, const float* __restrict__ ws,
                  float* __restrict__ out, int32_t* __restrict__ part,
                  int* __restrict__ arrivals, int M, int N, int K, int split,
                  int kper) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // stage buffers on a 1024-byte boundary (the swizzle atom)
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint8_t* out_tile = smem + kStages * kStageBytes;  // two 64×128 float halves
  const uint32_t out_base = base + kStages * kStageBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(out_tile + kOutBytes);
  int* last_flag = reinterpret_cast<int*>(bars + 2 * kStages);
  const uint32_t full0 = smem_addr(bars);
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tiles_m = (M + kTile - 1) / kTile;
  const int tiles_n = (N + kTile - 1) / kTile;
  const int nk = (K + kTileK - 1) / kTileK;
  const int units = tiles_m * tiles_n * split;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_of(u, split, kper, nk, tiles_m, tiles_n);
        for (int kt = t.kb; kt < t.ke; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t buf = base + stage * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(buf, &map_x, full, kt * kTileK, t.m0);
          tma_load_2d(buf + kTile * kTileK, &map_w, full, kt * kTileK, t.n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns rows [64·cw, 64·cw + 64) of a tile --
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int t128 = threadIdx.x - 128 * wg;
    const int warp = t128 >> 5;
    const int lane = t128 & 31;
    const bool arrive = lane == 0;
    int stage = 0;
    uint32_t phase = 0;
    int32_t d[64];
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit t = unit_of(u, split, kper, nk, tiles_m, tiles_n);
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0;
      int prev = -1;
      for (int kt = t.kb; kt < t.ke; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t buf = base + stage * kStageBytes;
        const uint64_t da = desc_k_major(buf + cw * 64 * kTileK);
        const uint64_t db = desc_k_major(buf + kTile * kTileK);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTileK / 32; ++kk) {
          wgmma_m64n128k32(d, da + 2 * kk, db + 2 * kk);  // +32 bytes of K
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's group has finished
        if (prev >= 0 && arrive) mbar_arrive(empty0 + 8 * prev);
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (prev >= 0 && arrive) mbar_arrive(empty0 + 8 * prev);

      // accumulator fragment: register 4j + r holds row 16·warp + lane/4
      // (+8 for r >= 2), column 8j + 2·(lane % 4) + (r % 2)
      const int row0 = t.m0 + cw * 64 + 16 * warp + (lane >> 2);
      const int col0 = t.n0 + 2 * (lane & 3);
      if (split > 1) {
        // Split-K: store this slice's partial sums, count the tile's
        // arrivals, and let the last slice to arrive add the others' sums
        // to its own and run the epilogue.  int32 addition is exact and
        // associative, so the bits do not depend on the order of arrival.
        const size_t mn = static_cast<size_t>(M) * N;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + 8 * h;
          if (m >= M) continue;
          int32_t* prow = part + t.slice * mn + static_cast<size_t>(m) * N;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = col0 + 8 * j + e;
              if (n < N) prow[n] = d[4 * j + 2 * h + e];
            }
          }
        }
        __threadfence();
        asm volatile("bar.sync 1, 256;\n" ::: "memory");  // both consumer warpgroups
        if (threadIdx.x == 128) {
          const int tile = u / split;
          const bool last = atomicAdd(arrivals + tile, 1) == split - 1;
          if (last) arrivals[tile] = 0;  // every slice has counted: reset
          *last_flag = last;
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (!*last_flag) continue;
        __threadfence();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + 8 * h;
          if (m >= M) continue;
          for (int s = 0; s < split; ++s) {
            if (s == t.slice) continue;
            const int32_t* prow = part + s * mn + static_cast<size_t>(m) * N;
#pragma unroll
            for (int j = 0; j < 16; ++j) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = col0 + 8 * j + e;
                if (n < N) d[4 * j + 2 * h + e] += __ldcg(prow + n);
              }
            }
          }
        }
      }
      if (tma_out) {
        // This warpgroup's 64×128 half of the tile goes through shared
        // memory: four slabs of 64 rows × 32 floats, each row 128 bytes
        // with its 16-byte chunks swizzled (chunk ^ row % 8) as the store's
        // tensor map reads them; one thread then issues the TMA stores and
        // the warpgroup goes on to its next tile while they drain.
        if (t128 == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        warpgroup_bar(2 + cw);  // the previous tile's stores have read the slabs
        uint8_t* half = out_tile + cw * (kOutBytes / 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + (lane >> 2) + 8 * h;  // row in the half
          const int m = t.m0 + cw * 64 + r;
          const float xm = m < M ? xs[m] : 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int n = col0 + 8 * j;
            const float w0 = n < N ? ws[n] : 0.f;
            const float w1 = n + 1 < N ? ws[n + 1] : 0.f;
            const int chunk = (2 * (j & 3) + ((lane & 3) >> 1)) ^ (r & 7);
            *reinterpret_cast<float2*>(half + (j >> 2) * (64 * 128) + r * 128 + chunk * 16 +
                                       8 * (lane & 1)) =
                make_float2(
                    __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * h]), xm), w0),
                    __fmul_rn(__fmul_rn(__int2float_rn(d[4 * j + 2 * h + 1]), xm), w1));
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        warpgroup_bar(2 + cw);
        if (t128 == 0 && t.m0 + cw * 64 < M) {
#pragma unroll
          for (int slab = 0; slab < kTile / kOutSlab; ++slab) {
            if (t.n0 + slab * kOutSlab < N) {
              tma_store_2d(&map_out, out_base + cw * (kOutBytes / 2) + slab * (64 * 128),
                           t.n0 + slab * kOutSlab, t.m0 + cw * 64);
            }
          }
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
        continue;
      }
      // direct stores (N % 4 != 0): each thread holds column pairs (n, n+1),
      // n even: one 8-byte store per pair where N is even
      const bool pairs = (N & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * h;
        if (m >= M) continue;
        const float xm = xs[m];
        float* orow = out + static_cast<size_t>(m) * N;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = col0 + 8 * j;
          const float v0 = __fmul_rn(__int2float_rn(d[4 * j + 2 * h]), xm);
          const float v1 = __fmul_rn(__int2float_rn(d[4 * j + 2 * h + 1]), xm);
          if (pairs && n + 1 < N) {
            *reinterpret_cast<float2*>(orow + n) =
                make_float2(__fmul_rn(v0, ws[n]), __fmul_rn(v1, ws[n + 1]));
          } else {
            if (n < N) orow[n] = __fmul_rn(v0, ws[n]);
            if (n + 1 < N) orow[n + 1] = __fmul_rn(v1, ws[n + 1]);
          }
        }
      }
    }
    // the last tile's stores must finish reading shared memory before exit
    if (tma_out && t128 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// The two kinds of tensor map: an int8 operand (rows, K) read in boxes of
// 128 rows × 128 bytes, and the float32 output (rows, cols) written in boxes
// of 64 rows × 32 floats (128 bytes); both row-major, 128-byte swizzle.
enum MapKind { kOperand, kOutput };

bool encode_map(EncodeTiled encode, CUtensorMap* map, MapKind kind, const void* ptr,
                int rows, int cols) {
  const int elem_bytes = kind == kOperand ? 1 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {kind == kOperand ? static_cast<cuuint32_t>(kTileK)
                                              : static_cast<cuuint32_t>(kOutSlab),
                             kind == kOperand ? static_cast<cuuint32_t>(kTile) : 64u};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map,
                kind == kOperand ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of recent (kind, pointer, rows, cols): a weight's map is encoded
// once, not on every call (a map holds nothing but these).
struct MapCache {
  struct Entry {
    const void* ptr = nullptr;
    int kind = 0, rows = 0, cols = 0;
    CUtensorMap map;
  };
  static constexpr int kSize = 64;
  Entry entries[kSize];
  std::mutex lock;

  bool get(EncodeTiled encode, CUtensorMap* map, MapKind kind, const void* ptr, int rows,
           int cols) {
    const uintptr_t h = (reinterpret_cast<uintptr_t>(ptr) >> 8) ^
                        (static_cast<uintptr_t>(rows) * 31u) ^
                        (static_cast<uintptr_t>(cols) * 7u) ^ static_cast<uintptr_t>(kind);
    Entry& e = entries[h % kSize];
    std::lock_guard<std::mutex> guard(lock);
    if (e.ptr != ptr || e.kind != kind || e.rows != rows || e.cols != cols) {
      if (!encode_map(encode, &e.map, kind, ptr, rows, cols)) {
        e.ptr = nullptr;
        return false;
      }
      e.ptr = ptr;
      e.kind = kind;
      e.rows = rows;
      e.cols = cols;
    }
    *map = e.map;
    return true;
  }
};

MapCache map_cache;

}  // namespace

// x (M, K) int8 row-major · w K-major: an (N, K) int8 row-major array ·
// xs (M,) · ws (N,) float32 → out (M, N) float32.  K % 16 == 0, K > 0, x
// and w 16-byte aligned.  `grid` blocks (at most one per SM) walk the
// ceil(M/128)·ceil(N/128)·split units; K is cut into slices of `kper`
// 128-byte steps.  With split > 1, `part` is an int32 workspace of
// split·M·N elements and `arrivals` ceil(M/128)·ceil(N/128) int32 zeros,
// left zero again (launches that share `arrivals` must not overlap).  out
// must not alias the inputs.
extern "C" int fixedpoint_matmul_wgmma_launch(const void* x, const void* w,
                                              const void* xs, const void* ws,
                                              void* out, void* part, void* arrivals,
                                              int M, int N, int K, int split,
                                              int kper, int grid, void* stream) {
  const int nk = (K + kTileK - 1) / kTileK;
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || split < 1 || kper < 1 ||
      (split - 1) * kper >= nk || grid < 1 ||
      (split > 1 && (part == nullptr || arrivals == nullptr)) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap map_x, map_w, map_out = {};
  if (!map_cache.get(encode, &map_x, kOperand, x, M, K) ||
      !map_cache.get(encode, &map_w, kOperand, w, N, K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // TMA stores of the output need its rows on 16-byte boundaries
  const int tma_out = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (tma_out && !map_cache.get(encode, &map_out, kOutput, out, M, N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = raise_smem_limit(wgmma_gemm_kernel, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_gemm_kernel<<<grid, kWgThreads, kWgSmem, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, map_out, tma_out, static_cast<const float*>(xs),
      static_cast<const float*>(ws),
      static_cast<float*>(out), static_cast<int32_t*>(part), static_cast<int*>(arrivals),
      M, N, K, split, kper);
  return static_cast<int>(cudaGetLastError());
}
