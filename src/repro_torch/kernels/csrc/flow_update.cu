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
// What bounds this design instead is its grouping: packets of one flow
// chain their EWMAs in batch order (the one stage of the data plane that
// is not batch-parallel), and every packet has to learn which earlier and
// later packets share its flow and its sketch cells.
//
// Design (the simple version that is right; the TPU kernel walks the whole
// batch in one sequential loop instead):
//
//   * One thread per packet.  All threads of a block stream the batch
//     through shared memory in tiles of kThreads packets (flow key = slot
//     or -1 for dead rows, the D cells, ts and length), so each thread
//     compares its own flow and cells against every packet of the batch
//     with broadcast shared-memory reads: O(B) compares per packet.
//   * Register chains: a live packet with no earlier live packet of its
//     slot is its flow's chain head.  The head loads the row once, walks
//     the later packets of its slot in batch order as the tiles pass,
//     carries the row in registers, writes each packet's seven register
//     features, and writes the row back once.  Chains are disjoint, so
//     there are no atomics and the result is deterministic.
//   * Count-min in its closed form (kernels/flow_update.py::
//     cms_estimate_update): in row d, packet p's estimate is
//     min(prior[d, c] + rank + 1, FLOW_CODE_MAX), rank = the number of
//     earlier live packets in the same cell, and the last live packet of a
//     cell writes min(prior + count, FLOW_CODE_MAX).  prior is read from
//     the input sketch and the result written into a separate output
//     sketch (the wrapper's clone), so no reader races the cell's writer.
//     atomicAdd is never used: every estimate depends on order.
//   * Integer traps: the EWMA delta is negative half the time, so
//     rounding_rshift is an arithmetic shift with the (x >= 0 ? half :
//     half - 1) bias; sat_shl clamps to [0, FLOW_CODE_MAX >> frac] before it
//     shifts; sums and differences that the oracle takes on Python ints are
//     taken in int64 and saturated back.
//
// Interface: a plain C entry point (bound with ctypes), launching on the
// caller's stream, allocating nothing and returning cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDepth = 8;
constexpr int kRegs = 8;
constexpr int kFeats = 8;
constexpr int64_t kCodeMax = (1 << 30) - 1;  // FLOW_CODE_MAX

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

// Packet j's flow key and cells, or -1 everywhere for a dead row and for a
// live row whose slot or cell lies outside the tables, which it reports in
// `bad` (1: the slot, 2: a cell) and skips rather than read past them.
template <int D>
__device__ __forceinline__ int32_t load_packet(
    int j, int n, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ cells, const int32_t* __restrict__ live,
    int n_slots, int width_c, int32_t (&cell)[D], int& bad) {
  bad = 0;
  int32_t key = -1;
  if (j < n && live[j] != 0) {
    key = slots[j];
    if (key < 0 || key >= n_slots) bad |= 1;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      cell[d] = cells[static_cast<size_t>(j) * D + d];
      if (cell[d] < 0 || cell[d] >= width_c) bad |= 2;
    }
  }
  if (key < 0 || bad != 0) {
    key = -1;
#pragma unroll
    for (int d = 0; d < D; ++d) cell[d] = -1;
  }
  return key;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flow_update_kernel(const int32_t* __restrict__ state,
                   const int32_t* __restrict__ cms,
                   const int32_t* __restrict__ slots,
                   const int32_t* __restrict__ cells,
                   const int32_t* __restrict__ ts,
                   const int32_t* __restrict__ length,
                   const int32_t* __restrict__ live,
                   int32_t* __restrict__ state_out,
                   int32_t* __restrict__ cms_out,
                   int32_t* __restrict__ feats,
                   int32_t* __restrict__ err, int n, int n_slots,
                   int width_c, Params k) {
  __shared__ int32_t s_key[kThreads];
  __shared__ int32_t s_cell[D][kThreads];
  __shared__ int32_t s_ts[kThreads];
  __shared__ int32_t s_len[kThreads];

  const int tid = threadIdx.x;
  const int p = blockIdx.x * kThreads + tid;
  int32_t cell[D];
  int bad;
  const int32_t key = load_packet<D>(p, n, slots, cells, live, n_slots,
                                     width_c, cell, bad);
  if (bad != 0) atomicOr(err, bad);  // the wrapper raises on it
  const bool alive = key >= 0;
  bool head = alive;  // until an earlier packet of the same flow shows up
  int rank[D];
  bool last[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    rank[d] = 0;
    last[d] = true;
  }
  int32_t row[kRegs];
#pragma unroll
  for (int r = 0; r < kRegs; ++r) row[r] = 0;

  for (int base = 0; base < n; base += kThreads) {
    const int j = base + tid;
    int32_t jc[D];
    int jbad;
    s_key[tid] = load_packet<D>(j, n, slots, cells, live, n_slots, width_c,
                                jc, jbad);
#pragma unroll
    for (int d = 0; d < D; ++d) s_cell[d][tid] = jc[d];
    s_ts[tid] = j < n ? ts[j] : 0;
    s_len[tid] = j < n ? length[j] : 0;
    __syncthreads();
    if (alive) {
      const int m = min(kThreads, n - base);
      for (int q = 0; q < m; ++q) {
        const int jj = base + q;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if (s_cell[d][q] == cell[d]) {
            if (jj < p) {
              ++rank[d];
            } else if (jj > p) {
              last[d] = false;
            }
          }
        }
        if (s_key[q] == key) {
          if (jj < p) {
            head = false;
          } else if (head) {  // the head walks its flow in batch order
            if (jj == p) {
              const int32_t* src = state + static_cast<size_t>(key) * kRegs;
#pragma unroll
              for (int r = 0; r < kRegs; ++r) row[r] = src[r];
            }
            step(row, s_ts[q], s_len[q], k,
                 feats + static_cast<size_t>(jj) * kFeats);
          }
        }
      }
    }
    __syncthreads();
  }

  if (alive) {
    if (head) {
      int32_t* dst = state_out + static_cast<size_t>(key) * kRegs;
#pragma unroll
      for (int r = 0; r < kRegs; ++r) dst[r] = row[r];
    }
    int64_t est = kCodeMax;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const size_t at = static_cast<size_t>(d) * width_c + cell[d];
      const int64_t e = min64(static_cast<int64_t>(cms[at]) + rank[d] + 1,
                              kCodeMax);
      est = min64(est, e);
      if (last[d]) cms_out[at] = static_cast<int32_t>(e);
    }
    feats[static_cast<size_t>(p) * kFeats + kFeats - 1] = sat_shl(est, k.frac);
  } else if (p < n) {
#pragma unroll
    for (int f = 0; f < kFeats; ++f) {
      feats[static_cast<size_t>(p) * kFeats + f] = 0;
    }
  }
}

template <int D>
void launch(const void* state, const void* cms, const void* slots,
            const void* cells, const void* ts, const void* length,
            const void* live, void* state_out, void* cms_out, void* feats,
            void* err, int n, int n_slots, int width_c, const Params& k,
            cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  flow_update_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(state), static_cast<const int32_t*>(cms),
      static_cast<const int32_t*>(slots), static_cast<const int32_t*>(cells),
      static_cast<const int32_t*>(ts), static_cast<const int32_t*>(length),
      static_cast<const int32_t*>(live), static_cast<int32_t*>(state_out),
      static_cast<int32_t*>(cms_out), static_cast<int32_t*>(feats),
      static_cast<int32_t*>(err), n, n_slots, width_c, k);
}

}  // namespace

// state (S, 8) · cms (D, Wc) · slots, ts, length, live (B,) · cells (B, D),
// all int32 → state_out (S, 8) and cms_out (D, Wc), which the caller fills
// with copies of state and cms, and feats (B, 8) int32.  err is one int32
// the caller zeroes: the kernel ORs 1 into it for a live packet whose slot
// lies outside [0, S) and 2 for one with a cell outside [0, Wc), and skips
// that packet.
extern "C" int flow_update_launch(const void* state, const void* cms,
                                  const void* slots, const void* cells,
                                  const void* ts, const void* length,
                                  const void* live, void* state_out,
                                  void* cms_out, void* feats, void* err, int n,
                                  int n_slots, int depth, int width_c,
                                  int frac, int ewma_shift, int byte_shift,
                                  int dur_shift, void* stream) {
  if (n < 0 || n_slots < 1 || depth < 1 || depth > kMaxDepth ||
      width_c < 1 || frac < 0 || frac > 30 || ewma_shift < 0 ||
      ewma_shift > 30 || byte_shift < 0 || byte_shift > 30 ||
      dur_shift < 0 || dur_shift > 30) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Params k{frac, ewma_shift, byte_shift, dur_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLOW_UPDATE_CASE(D)                                                  \
  case D:                                                                    \
    launch<D>(state, cms, slots, cells, ts, length, live, state_out, cms_out, \
              feats, err, n, n_slots, width_c, k, st);                       \
    break;
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
  return static_cast<int>(cudaGetLastError());
}
