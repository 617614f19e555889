// Multi-forest tree-ensemble traversal for Hopper (sm_90a): the pointer
// chase and the range-table form of the forest lane.
//
// Replaces repro/kernels/forest_traversal.py::forest_traverse_pallas
// ("chase") and ::forest_range_pallas ("range") and computes what their
// masked (one-hot) formulations compute, bit for bit.  Per packet p with
// forest slot s, for every tree t with tree_on[s,t] > 0:
//
//   chase:  cur = 0; max_depth times:
//             cur = x[feat(cur)] <= thresh(cur) ? left(cur) : right(cur)
//           leaf = payload(cur)
//   range:  word = AND over entries i of
//             (x[feat_i] <= thresh_i ? ~0u : lmask_i)
//           idx  = popcount(((word & -word) - 1) & low L bits)
//           leaf = idx < L ? payload[idx] : 0
//   vote:   mode[s] == 1 (classify): out[p, leaf] += 1 << frac
//           otherwise (regress):     out[p, 0]    += leaf
//
// Cases reproduced as the masked form has them (install_forest rejects
// every one, the kernel still matches): a node index outside [0, N) reads
// an all-zero record; a feature outside [0, W) reads x = 0; a classify leaf
// outside [0, W) votes nowhere; a slot outside [0, F) gives an all-zero
// row; word == 0 gives idx = L and so leaf = 0.
//
// What bounds it on this card.  At the server's defaults (F=8 forests,
// T=16 trees, N=64 nodes, depth 6, NI=31 range entries, L=32 leaves,
// W=32, B=2048 packets) one batch is ≈ 0.5 MB of codes and output plus
// ≈ 164 KB of tables, and a few million integer compares and selects, so
// both the memory and the operation bounds are around a microsecond.  The
// chase is bound by latency instead: every step is a dependent
// load(node record) → load(x[feat]) → compare chain, max_depth long.  The
// range form has no chain, but reads NI entries per tree.
//
// Design.  One warp per packet; lane t owns tree t (trees in steps of 32
// when T > 32).  The packet's W ≤ 128 codes sit in shared memory, so the
// x[feat] reads are shared-memory reads.  The tables are read from global
// memory in the control plane's own layout — nodes (F, T, N, 5), feat /
// thresh / lmask (F, T, NI), payload (F, T, L) — with no per-batch
// relayout; at the defaults they total ≈ 164 KB and stay in L2 across the
// warps of a batch, so there is no shared-memory staging yet.  Enough warps
// are in flight (one per packet) to hide part of the chase's latency.
// Votes reduce across the warp in uint32, where wraparound is defined and
// addition is order-free, so the result is exact: regress forests sum
// their leaves by a shuffle reduction into lane 0; classify forests
// broadcast each tree's leaf by shuffle and lane j counts the votes for
// output column j (and j+32, j+64, j+96), then multiplies by 1 << frac.
// Tables are pointers, never compiled in, so installing a forest never
// rebuilds anything.
//
// Interface: plain C entry points (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxWidth = 128;
constexpr int kMaxCols = kMaxWidth / 32;
constexpr int kClassify = 1;  // FOREST_CLASSIFY
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t feature(const int32_t* xs, int32_t f,
                                           int width) {
  return (f >= 0 && f < width) ? xs[f] : 0;
}

struct Chase {
  const int32_t* nodes;  // (F, T, N, 5)
  int n_nodes;
  int max_depth;

  __device__ __forceinline__ int32_t leaf(int ft, const int32_t* xs,
                                          int width) const {
    const int32_t* tn = nodes + static_cast<size_t>(ft) * n_nodes * 5;
    int32_t cur = 0;
    for (int d = 0; d < max_depth; ++d) {
      int32_t f = 0, th = 0, l = 0, r = 0;  // out-of-range: all-zero record
      if (cur >= 0 && cur < n_nodes) {
        const int32_t* rec = tn + static_cast<size_t>(cur) * 5;
        f = rec[0];
        th = rec[1];
        l = rec[2];
        r = rec[3];
      }
      cur = feature(xs, f, width) <= th ? l : r;  // leaves self-loop
    }
    return (cur >= 0 && cur < n_nodes) ? tn[static_cast<size_t>(cur) * 5 + 4]
                                       : 0;
  }
};

struct Range {
  const int32_t* feat;     // (F, T, NI)
  const int32_t* thresh;   // (F, T, NI)
  const int32_t* lmask;    // (F, T, NI) uint32 bit patterns
  const int32_t* payload;  // (F, T, L)
  int n_entries;
  int n_leaves;

  __device__ __forceinline__ int32_t leaf(int ft, const int32_t* xs,
                                          int width) const {
    const size_t e0 = static_cast<size_t>(ft) * n_entries;
    uint32_t word = kFull;
    for (int i = 0; i < n_entries; ++i) {
      if (!(feature(xs, feat[e0 + i], width) <= thresh[e0 + i])) {
        word &= static_cast<uint32_t>(lmask[e0 + i]);
      }
    }
    const uint32_t below = (word & (0u - word)) - 1u;  // ones under the lowest set bit
    const uint32_t low = n_leaves >= 32 ? kFull : ((1u << n_leaves) - 1u);
    const int idx = __popc(below & low);
    return idx < n_leaves
               ? payload[static_cast<size_t>(ft) * n_leaves + idx]
               : 0;
  }
};

template <class Lane>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
forest_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ slot,
              const int32_t* __restrict__ tree_on,
              const int32_t* __restrict__ mode, int32_t* __restrict__ out,
              int n_batch, int n_forests, int n_trees, int width, int frac,
              Lane lane_fn) {
  __shared__ int32_t xs_all[kWarpsPerBlock][kMaxWidth];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + warp;
  if (p >= n_batch) return;  // warp-uniform
  int32_t* xs = xs_all[warp];
  const int32_t* xp = x + static_cast<size_t>(p) * width;
  for (int j = lane; j < width; j += 32) xs[j] = xp[j];
  __syncwarp();

  const int s = slot[p];
  uint32_t cnt[kMaxCols];
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) cnt[c] = 0;
  uint32_t reg = 0;
  bool classify = false;
  if (s >= 0 && s < n_forests) {  // warp-uniform
    classify = mode[s] == kClassify;
    for (int t0 = 0; t0 < n_trees; t0 += 32) {
      const int t = t0 + lane;
      bool live = false;
      int32_t leaf = 0;
      if (t < n_trees) {
        const int ft = s * n_trees + t;
        live = tree_on[ft] > 0;
        if (live) leaf = lane_fn.leaf(ft, xs, width);
      }
      if (classify) {
        // a dead tree votes for column -1, i.e. nowhere
        const int32_t vote = live ? leaf : -1;
        const int n = min(32, n_trees - t0);
        for (int k = 0; k < n; ++k) {
          const int32_t v = __shfl_sync(kFull, vote, k);
#pragma unroll
          for (int c = 0; c < kMaxCols; ++c) cnt[c] += (v == lane + 32 * c);
        }
      } else if (live) {
        reg += static_cast<uint32_t>(leaf);
      }
    }
  }
  if (!classify) {  // warp-uniform
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) reg += __shfl_xor_sync(kFull, reg, o);
  }

  int32_t* op = out + static_cast<size_t>(p) * width;
  const uint32_t one_q = 1u << frac;
#pragma unroll
  for (int c = 0; c < kMaxCols; ++c) {
    const int j = lane + 32 * c;
    if (j < width) {
      const uint32_t v = classify ? cnt[c] * one_q : (j == 0 ? reg : 0u);
      op[j] = static_cast<int32_t>(v);
    }
  }
}

template <class Lane>
int launch(const void* x, const void* slot, const void* tree_on,
           const void* mode, void* out, int n_batch, int n_forests,
           int n_trees, int width, int frac, const Lane& lane_fn,
           void* stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n_batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  forest_kernel<Lane><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(slot),
      static_cast<const int32_t*>(tree_on), static_cast<const int32_t*>(mode),
      static_cast<int32_t*>(out), n_batch, n_forests, n_trees, width, frac,
      lane_fn);
  return static_cast<int>(cudaGetLastError());
}

bool common_ok(int n_batch, int n_forests, int n_trees, int width, int frac) {
  return n_batch >= 0 && n_forests >= 1 && n_trees >= 1 && width >= 1 &&
         width <= kMaxWidth && frac >= 0 && frac <= 30;
}

}  // namespace

extern "C" int forest_max_width() { return kMaxWidth; }

// x (B, W) int32 · slot (B,) int32 · nodes (F, T, N, 5) int32 ·
// tree_on (F, T) int32 · mode (F,) int32 → out (B, W) int32.
extern "C" int forest_chase_launch(const void* x, const void* slot,
                                   const void* nodes, const void* tree_on,
                                   const void* mode, void* out, int n_batch,
                                   int n_forests, int n_trees, int n_nodes,
                                   int width, int max_depth, int frac,
                                   void* stream) {
  if (!common_ok(n_batch, n_forests, n_trees, width, frac) || n_nodes < 1 ||
      max_depth < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_batch == 0) return static_cast<int>(cudaSuccess);
  const Chase lane_fn{static_cast<const int32_t*>(nodes), n_nodes, max_depth};
  return launch(x, slot, tree_on, mode, out, n_batch, n_forests, n_trees,
                width, frac, lane_fn, stream);
}

// x (B, W) int32 · slot (B,) int32 · feat, thresh, lmask (F, T, NI) int32
// (lmask as uint32 bit patterns) · payload (F, T, L) int32 · tree_on (F, T)
// int32 · mode (F,) int32 → out (B, W) int32.  1 <= L <= 32.
extern "C" int forest_range_launch(const void* x, const void* slot,
                                   const void* feat, const void* thresh,
                                   const void* lmask, const void* payload,
                                   const void* tree_on, const void* mode,
                                   void* out, int n_batch, int n_forests,
                                   int n_trees, int n_entries, int n_leaves,
                                   int width, int frac, void* stream) {
  if (!common_ok(n_batch, n_forests, n_trees, width, frac) || n_entries < 1 ||
      n_leaves < 1 || n_leaves > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_batch == 0) return static_cast<int>(cudaSuccess);
  const Range lane_fn{static_cast<const int32_t*>(feat),
                      static_cast<const int32_t*>(thresh),
                      static_cast<const int32_t*>(lmask),
                      static_cast<const int32_t*>(payload), n_entries,
                      n_leaves};
  return launch(x, slot, tree_on, mode, out, n_batch, n_forests, n_trees,
                width, frac, lane_fn, stream);
}
