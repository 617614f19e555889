// Per-flow register update + count-min sketch + feature emit for Hopper
// (sm_90a): the stateful stage of the raw-packet flow engine.
//
// Replaces repro/kernels/flow_update.py::flow_update_pallas and computes
// what repro/kernels/ref.py::flow_update_numpy computes, bit for bit, on its
// contract (ts a non-negative int32, registers and lengths in
// [0, FLOW_CODE_MAX], slots in [0, S), cells in [0, Wc)).  For every live
// packet p, in batch order:
//
//   row = state[slot[p]]
//   cnt == 0:  the packet opens the flow (first = t, EWMAs seeded, min = max
//              = len, counts 1 and len)
//   else:      counts saturate at FLOW_CODE_MAX; the IAT EWMA seeds on the
//              second packet and then, like the length EWMA, moves by
//              rounding_rshift(new - old, ewma_shift); min/max update
//   cms[d, cells[p, d]] += 1 (saturating) for every sketch row d
//   features[p] = sat_shl of (count, bytes >> byte_shift, the two EWMAs,
//                 min, max, max(t - first, 0) >> dur_shift, the count-min
//                 estimate = min over rows) at frac
//
// Dead rows touch nothing, do not count in the sketch and emit zeros.
//
// What bounds it on this card.  At the serving defaults (S = 2^14 slots,
// a 2 x 4096 sketch, B = 2048 packets) the function must read and write
// the 512 KiB register file and the 32 KiB sketch and do ~70 integer
// operations per packet: well under a microsecond of bytes or operations.
// What bounds a design instead is its grouping: packets of one flow chain
// their EWMAs in batch order (the one stage of the data plane that is not
// batch-parallel), and every packet has to learn which earlier and later
// packets share its flow and its sketch cells.
//
// Design: two kernels, so that finding the groups runs on the whole card
// and only the walk along each flow's chain stays sequential.
//
//   1. flow_links_kernel, one warp per packet i, 8 per block (256 blocks
//      at B = 2048).  The block stages the batch through shared memory in
//      tiles of 256 packets (a valid packet's slot and cells, -1 for a dead
//      one or one outside the tables, checked once per packet and block;
//      each thread loads its packet of the next tile while the warps
//      compare this one);
//      each warp compares its packet with a tile, lane l taking packets l,
//      l + 32, ... (conflict-free reads, a loop of fixed length, unrolled).
//      Warp reductions (__reduce_add_sync, __any_sync) then give: how many
//      valid packets have a smaller slot (`less`), how many of i's flow come
//      before and after it, and per sketch row d rank_d[i] = the earlier
//      valid packets in i's cell and whether a later one exists (else i
//      writes the cell).  less + (packets of i's flow before i) is i's place
//      among the valid packets sorted by (slot, batch index), so i writes
//      itself there into order[]: each flow becomes a contiguous run in
//      batch order, and its head (no earlier packet) records where the run
//      starts and how long it is.  Sums and ors do not depend on the order
//      of the lanes, so the result is deterministic and needs no atomics
//      and no zeroed workspace.  The same kernel copies the register file
//      and the sketch into the outputs (every thread of the grid a strided
//      share) and zeroes the error word.  A live packet whose slot or cell
//      lies outside the tables is marked in meta[i] and takes no part; the
//      wrapper raises on it.
//   2. flow_apply_kernel, one thread per packet.  A chain head loads its
//      flow's row from the input register file once, walks its run of
//      order[] (step() per packet: its seven register features), and
//      writes the row into the output register file once.  The run is read
//      kGroup packets at a time, with their ts and lengths, one group ahead
//      of the steps: only the row carries from step to step.  Every valid
//      packet takes its count-min estimate in its closed form
//      (kernels/flow_update.py::cms_estimate_update): in row d,
//      min(prior + rank_d + 1, FLOW_CODE_MAX) with prior read from the input
//      sketch, and the last valid packet of a cell writes that value, which
//      is min(prior + count, FLOW_CODE_MAX), into the output sketch.  The
//      kernel boundary orders kernel 1's copies before these writes, and no
//      thread reads what another writes.
//
//   Chains are disjoint and serial by nature: a batch that is one flow
//   (B packets of one slot) is one thread's walk of B steps, as in the
//   TPU kernel's loop.
//
//   Integer traps: the EWMA delta is negative half the time, so
//   rounding_rshift is an arithmetic shift with the (x >= 0 ? half :
//   half - 1) bias; sat_shl clamps to [0, FLOW_CODE_MAX >> frac] before it
//   shifts; sums and differences that the oracle takes on Python ints are
//   taken in int64 and saturated back.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLinkWarps = 8;        // packets per links block, one warp each
constexpr int kLinkThreads = kLinkWarps * 32;
constexpr int kApplyThreads = 32;
constexpr int kGroup = 8;            // packets of a flow loaded together
constexpr int kCopyPerThread = 4;    // elements each thread copies, at least
constexpr int kMaxDepth = 8;
constexpr int kRegs = 8;
constexpr int kFeats = 8;
constexpr int64_t kCodeMax = (1 << 30) - 1;  // FLOW_CODE_MAX

// meta[i] bits
constexpr int32_t kValid = 1;        // live, slot and every cell in range
constexpr int32_t kHead = 2;         // no earlier live packet of its slot
constexpr int32_t kLastShift = 2;    // bit 2 + d: no later live packet in
                                     // its cell of sketch row d
constexpr int32_t kBadShift = 16;    // bits 16, 17: the error word's 1, 2

// register columns (kernels/ref.py REG_*)
constexpr int kCount = 0, kBytes = 1, kLastTs = 2, kFirstTs = 3,
              kEwmaIat = 4, kEwmaLen = 5, kMinLen = 6, kMaxLen = 7;

struct Params {
  int frac;
  int ewma_shift;
  int byte_shift;
  int dur_shift;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// ref.sat_shl_np: clamp to [0, FLOW_CODE_MAX >> shift], then shift
__device__ __forceinline__ int32_t sat_shl(int64_t v, int shift) {
  const int64_t hi = kCodeMax >> shift;
  return static_cast<int32_t>(min64(max64(v, 0), hi) << shift);
}

// ref.rounding_rshift_np: arithmetic shift, ties away from zero
__device__ __forceinline__ int64_t rounding_rshift(int64_t x, int shift) {
  if (shift <= 0) return x;
  const int64_t half = int64_t{1} << (shift - 1);
  return (x + (x >= 0 ? half : half - 1)) >> shift;
}

// One packet through its flow's row (flow_update_numpy's loop body without
// the sketch); writes the packet's seven register features.
__device__ __forceinline__ void step(int32_t (&row)[kRegs], int32_t t,
                                     int32_t len_raw, const Params& k,
                                     int32_t* __restrict__ feat) {
  const int64_t ln = len_raw > 0 ? len_raw : 0;
  const int64_t cnt = row[kCount];
  const int64_t len_q = sat_shl(ln, k.frac);
  int64_t cnt2, byte, first, iat_e, len_e, mn, mx;
  if (cnt == 0) {  // fresh slot: this packet opens the flow
    first = t;
    iat_e = 0;
    len_e = len_q;
    mn = ln;
    mx = ln;
    byte = min64(ln, kCodeMax);
    cnt2 = 1;
  } else {
    const int64_t iat_q =
        sat_shl(max64(static_cast<int64_t>(t) - row[kLastTs], 0), k.frac);
    iat_e = cnt == 1 ? iat_q
                     : row[kEwmaIat] + rounding_rshift(iat_q - row[kEwmaIat],
                                                       k.ewma_shift);
    len_e = row[kEwmaLen] + rounding_rshift(len_q - row[kEwmaLen],
                                            k.ewma_shift);
    mn = min64(row[kMinLen], ln);
    mx = max64(row[kMaxLen], ln);
    byte = min64(row[kBytes] + ln, kCodeMax);
    cnt2 = min64(cnt + 1, kCodeMax);
    first = row[kFirstTs];
  }
  row[kCount] = static_cast<int32_t>(cnt2);
  row[kBytes] = static_cast<int32_t>(byte);
  row[kLastTs] = t;
  row[kFirstTs] = static_cast<int32_t>(first);
  row[kEwmaIat] = static_cast<int32_t>(iat_e);
  row[kEwmaLen] = static_cast<int32_t>(len_e);
  row[kMinLen] = static_cast<int32_t>(mn);
  row[kMaxLen] = static_cast<int32_t>(mx);
  feat[0] = sat_shl(cnt2, k.frac);
  feat[1] = sat_shl(byte >> k.byte_shift, k.frac);
  feat[2] = static_cast<int32_t>(iat_e);
  feat[3] = static_cast<int32_t>(len_e);
  feat[4] = sat_shl(mn, k.frac);
  feat[5] = sat_shl(mx, k.frac);
  feat[6] = sat_shl(max64(static_cast<int64_t>(t) - first, 0) >> k.dur_shift,
                    k.frac);
}

// 0 for a packet whose slot and cells lie inside the tables, else the
// error word's bits: 1 for its slot, 2 for a cell
template <int D>
__device__ __forceinline__ int32_t valid_packet(
    int j, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ cells, int n_slots, int width_c) {
  const int32_t s = slots[j];
  int32_t bad = s < 0 || s >= n_slots ? 1 : 0;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int32_t c = cells[static_cast<size_t>(j) * D + d];
    if (c < 0 || c >= width_c) bad |= 2;
  }
  return bad;
}

// packet j's live flag, slot and cells (a dead packet past the batch's end)
template <int D>
__device__ __forceinline__ void load_raw(
    int j, int n, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ cells, const int32_t* __restrict__ live,
    int32_t& lv, int32_t& sl, int32_t (&cl)[D]) {
  lv = 0;
  sl = -1;
#pragma unroll
  for (int d = 0; d < D; ++d) cl[d] = -1;
  if (j < n) {
    lv = live[j];
    sl = slots[j];
#pragma unroll
    for (int d = 0; d < D; ++d) cl[d] = cells[static_cast<size_t>(j) * D + d];
  }
}

// packets g .. g + kGroup - 1 of a flow (q = -1 past its end), with their
// ts and lengths
__device__ __forceinline__ void load_group(
    const int32_t* __restrict__ flow, int g, int len,
    const int32_t* __restrict__ ts, const int32_t* __restrict__ length,
    int (&q)[kGroup], int (&t)[kGroup], int (&ln)[kGroup]) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) q[u] = g + u < len ? flow[g + u] : -1;
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    t[u] = q[u] >= 0 ? ts[q[u]] : 0;
    ln[u] = q[u] >= 0 ? length[q[u]] : 0;
  }
}

template <int D>
__global__ void __launch_bounds__(kLinkThreads)
flow_links_kernel(const int32_t* __restrict__ state,
                  const int32_t* __restrict__ cms,
                  const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ cells,
                  const int32_t* __restrict__ live,
                  int32_t* __restrict__ state_out,
                  int32_t* __restrict__ cms_out,
                  int32_t* __restrict__ order, int32_t* __restrict__ chain,
                  int32_t* __restrict__ meta, int32_t* __restrict__ rank,
                  int32_t* __restrict__ err, int n, int n_slots,
                  int width_c) {
  __shared__ int32_t s_key[kLinkThreads];
  __shared__ int32_t s_cell[D][kLinkThreads];

  // the copy-through, a strided share for every thread of the grid
  const size_t tid = static_cast<size_t>(blockIdx.x) * kLinkThreads +
                     threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * kLinkThreads;
  const size_t n_state = static_cast<size_t>(n_slots) * kRegs;
  const size_t n_cms = static_cast<size_t>(D) * width_c;
  for (size_t e = tid; e < n_state; e += stride) state_out[e] = state[e];
  for (size_t e = tid; e < n_cms; e += stride) cms_out[e] = cms[e];
  if (tid == 0) *err = 0;

  // this warp's packet i; an idle warp or a packet that takes no part keeps
  // key -2 and cells -2, which match no staged packet
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kLinkWarps + (threadIdx.x >> 5);
  int32_t key = -2;
  int32_t cell[D];
  int32_t bad = 0;
#pragma unroll
  for (int d = 0; d < D; ++d) cell[d] = -2;
  if (i < n && live[i] != 0) {
    bad = valid_packet<D>(i, slots, cells, n_slots, width_c);
    if (bad == 0) {
      key = slots[i];
#pragma unroll
      for (int d = 0; d < D; ++d) cell[d] = cells[static_cast<size_t>(i) * D + d];
    }
  }

  unsigned less = 0, before_f = 0, after_f = 0;
  unsigned cnt[D];
  bool later[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    cnt[d] = 0;
    later[d] = false;
  }
  // this thread's packet of the next tile, loaded while the tile before it
  // is compared
  int32_t r_live, r_slot, r_cell[D];
  load_raw<D>(threadIdx.x, n, slots, cells, live, r_live, r_slot, r_cell);
  for (int base = 0; base < n; base += kLinkThreads) {
    // stage a tile of packets: a valid one's slot and cells, else -1
    bool ok = r_live != 0 && r_slot >= 0 && r_slot < n_slots;
#pragma unroll
    for (int d = 0; d < D; ++d) ok &= r_cell[d] >= 0 && r_cell[d] < width_c;
    s_key[threadIdx.x] = ok ? r_slot : -1;
#pragma unroll
    for (int d = 0; d < D; ++d) s_cell[d][threadIdx.x] = ok ? r_cell[d] : -1;
    __syncthreads();
    load_raw<D>(base + kLinkThreads + threadIdx.x, n, slots, cells, live,
                r_live, r_slot, r_cell);
    if (key >= 0) {  // warp-uniform
#pragma unroll
      for (int u = 0; u < kLinkThreads / 32; ++u) {
        const int q = u * 32 + lane;
        const int jj = base + q;
        const int32_t kj = s_key[q];
        const bool same = kj == key;
        const bool before = jj < i;
        const bool after = jj > i;
        less += kj >= 0 && kj < key;
        before_f += same && before;
        after_f += same && after;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const bool eq = s_cell[d][q] == cell[d];
          cnt[d] += eq && before;
          later[d] |= eq && after;
        }
      }
    }
    __syncthreads();  // the tile is read before the next one is staged
  }
  if (i >= n) return;
  if (key < 0) {  // dead, or outside the tables: no part
    if (lane == 0) meta[i] = bad << kBadShift;
    return;
  }
  constexpr unsigned kFull = 0xffffffffu;
  less = __reduce_add_sync(kFull, less);
  before_f = __reduce_add_sync(kFull, before_f);
  after_f = __reduce_add_sync(kFull, after_f);
  int32_t m = kValid | (before_f == 0 ? kHead : 0);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    cnt[d] = __reduce_add_sync(kFull, cnt[d]);
    if (!__any_sync(kFull, later[d])) m |= 1 << (kLastShift + d);
  }
  if (lane == 0) {
    // valid packets sorted by (slot, batch index): i's flow occupies
    // order[less, less + its packets), in batch order
    order[less + before_f] = i;
    if (before_f == 0) {
      chain[i] = static_cast<int32_t>(less);
      chain[static_cast<size_t>(n) + i] = static_cast<int32_t>(after_f + 1);
    }
    meta[i] = m;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      rank[static_cast<size_t>(d) * n + i] = static_cast<int32_t>(cnt[d]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kApplyThreads)
flow_apply_kernel(const int32_t* __restrict__ state,
                  const int32_t* __restrict__ cms,
                  const int32_t* __restrict__ slots,
                  const int32_t* __restrict__ cells,
                  const int32_t* __restrict__ ts,
                  const int32_t* __restrict__ length,
                  const int32_t* __restrict__ order,
                  const int32_t* __restrict__ chain,
                  const int32_t* __restrict__ meta,
                  const int32_t* __restrict__ rank,
                  int32_t* __restrict__ state_out,
                  int32_t* __restrict__ cms_out,
                  int32_t* __restrict__ feats, int32_t* __restrict__ err,
                  int n, int width_c, Params k) {
  const int p = blockIdx.x * kApplyThreads + threadIdx.x;
  if (p >= n) return;
  const int32_t m = meta[p];
  int32_t* fp = feats + static_cast<size_t>(p) * kFeats;
  if (!(m & kValid)) {
    if (m >> kBadShift) atomicOr(err, m >> kBadShift);  // the wrapper raises
#pragma unroll
    for (int f = 0; f < kFeats; ++f) fp[f] = 0;
    return;
  }
  if (m & kHead) {  // walk the flow in batch order, kGroup packets at a time
    const int32_t* flow = order + chain[p];
    const int len = chain[static_cast<size_t>(n) + p];
    const size_t at = static_cast<size_t>(slots[p]) * kRegs;
    int32_t row[kRegs];
#pragma unroll
    for (int r = 0; r < kRegs; ++r) row[r] = state[at + r];
    // the next group's packets, their ts and lengths are loaded while this
    // group's steps run: none of them depends on the row
    int q[kGroup], t[kGroup], ln[kGroup];
    load_group(flow, 0, len, ts, length, q, t, ln);
    for (int g = 0; g < len; g += kGroup) {
      int qn[kGroup], tn[kGroup], lnn[kGroup];
      load_group(flow, g + kGroup, len, ts, length, qn, tn, lnn);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (q[u] >= 0) {
          step(row, t[u], ln[u], k, feats + static_cast<size_t>(q[u]) * kFeats);
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        q[u] = qn[u];
        t[u] = tn[u];
        ln[u] = lnn[u];
      }
    }
#pragma unroll
    for (int r = 0; r < kRegs; ++r) state_out[at + r] = row[r];
  }
  int64_t est = kCodeMax;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const size_t at = static_cast<size_t>(d) * width_c +
                      cells[static_cast<size_t>(p) * D + d];
    const int64_t e = min64(static_cast<int64_t>(cms[at]) +
                                rank[static_cast<size_t>(d) * n + p] + 1,
                            kCodeMax);
    est = min64(est, e);
    if (m & (1 << (kLastShift + d))) cms_out[at] = static_cast<int32_t>(e);
  }
  fp[kFeats - 1] = sat_shl(est, k.frac);
}

int cdiv(size_t a, size_t b) { return static_cast<int>((a + b - 1) / b); }

template <int D>
cudaError_t launch(const int32_t* state, const int32_t* cms,
                   const int32_t* slots, const int32_t* cells,
                   const int32_t* ts, const int32_t* length,
                   const int32_t* live, int32_t* state_out, int32_t* cms_out,
                   int32_t* feats, int32_t* scratch, int32_t* err, int n,
                   int n_slots, int width_c, const Params& k,
                   cudaStream_t stream) {
  int32_t* order = scratch;
  int32_t* chain = scratch + n;                          // 2n: start, length
  int32_t* meta = scratch + 3 * static_cast<size_t>(n);
  int32_t* rank = scratch + 4 * static_cast<size_t>(n);  // D·n
  // enough blocks for every packet's warp, and for the copy-through at
  // kCopyPerThread elements a thread
  const size_t copy = static_cast<size_t>(n_slots) * kRegs +
                      static_cast<size_t>(D) * width_c;
  const int grid1 =
      std::max(cdiv(n, kLinkWarps),
               std::min(cdiv(copy, kLinkThreads * kCopyPerThread), 4096));
  flow_links_kernel<D><<<grid1, kLinkThreads, 0, stream>>>(
      state, cms, slots, cells, live, state_out, cms_out, order, chain, meta,
      rank, err, n, n_slots, width_c);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  flow_apply_kernel<D><<<cdiv(n, kApplyThreads), kApplyThreads, 0, stream>>>(
      state, cms, slots, cells, ts, length, order, chain, meta, rank,
      state_out, cms_out, feats, err, n, width_c, k);
  return cudaGetLastError();
}

}  // namespace

// state (S, 8) · cms (D, Wc) · slots, ts, length, live (B,) · cells (B, D),
// all int32 → state_out (S, 8), cms_out (D, Wc) and feats (B, 8) int32,
// none aliasing an input.  scratch is (4 + D)·B int32 of workspace, any
// contents.  err is one int32 that the kernels set: 1 for a live packet
// whose slot lies outside [0, S), 2 for one with a cell outside [0, Wc);
// such a packet is skipped, and the outputs are then not the function's.
// 1 <= B; launches the two kernels on `stream`.
extern "C" int flow_update_launch(const void* state, const void* cms,
                                  const void* slots, const void* cells,
                                  const void* ts, const void* length,
                                  const void* live, void* state_out,
                                  void* cms_out, void* feats, void* scratch,
                                  void* err, int n, int n_slots, int depth,
                                  int width_c, int frac, int ewma_shift,
                                  int byte_shift, int dur_shift,
                                  void* stream) {
  if (n < 1 || n_slots < 1 || depth < 1 || depth > kMaxDepth ||
      width_c < 1 || frac < 0 || frac > 30 || ewma_shift < 0 ||
      ewma_shift > 30 || byte_shift < 0 || byte_shift > 30 ||
      dur_shift < 0 || dur_shift > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params k{frac, ewma_shift, byte_shift, dur_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLOW_UPDATE_CASE(D)                                                    \
  case D:                                                                      \
    return static_cast<int>(launch<D>(                                         \
        static_cast<const int32_t*>(state), static_cast<const int32_t*>(cms),  \
        static_cast<const int32_t*>(slots), static_cast<const int32_t*>(cells),\
        static_cast<const int32_t*>(ts), static_cast<const int32_t*>(length),  \
        static_cast<const int32_t*>(live), static_cast<int32_t*>(state_out),   \
        static_cast<int32_t*>(cms_out), static_cast<int32_t*>(feats),          \
        static_cast<int32_t*>(scratch), static_cast<int32_t*>(err), n,         \
        n_slots, width_c, k, st));
  switch (depth) {
    FLOW_UPDATE_CASE(1)
    FLOW_UPDATE_CASE(2)
    FLOW_UPDATE_CASE(3)
    FLOW_UPDATE_CASE(4)
    FLOW_UPDATE_CASE(5)
    FLOW_UPDATE_CASE(6)
    FLOW_UPDATE_CASE(7)
    FLOW_UPDATE_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLOW_UPDATE_CASE
}
