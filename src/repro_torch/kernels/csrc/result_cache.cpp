// The ingress result cache's probe sweeps on the host: one call per chunk.
//
// The table is ResultCache's own numpy arrays, passed by pointer: keys
// (cap, key_words) uint64, vals (cap, val_bytes) uint8, state (cap,) uint8
// (0 empty, 1 full, 2 tombstone), model (cap,) int64 and the claim scratch
// (cap,) int64.  cap is a power of two.  Row i's chain starts at
// hash & mask and steps by ((hash >> 32) << 1 | 1) & mask, an odd step, so
// the chain covers the whole table; at most max_probe slots are visited.
//
// rc_insert reproduces the plain version's probe rounds
// (kernels/ref.py::result_cache_insert_ref) exactly, so both leave the same
// table: in each round every pending row looks at its current slot, rows
// whose slot is full refresh a matching key in place, rows whose slot is
// not full scatter a claim into the scratch (the last row of the round to
// write a slot wins it), the winners are written, and a loser whose slot
// now holds its own key refreshes it.  Rows still pending after max_probe
// rounds are dropped.  Writes to one slot land in row order, as numpy's
// fancy assignment does.
//
// Plain C interface, bound with ctypes; built with the host C++ compiler.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline bool same_key(const uint64_t* a, const uint64_t* b, int64_t words) {
  return std::memcmp(a, b, static_cast<size_t>(words) * 8) == 0;
}

// rows ahead whose slots are prefetched: the table lies outside the core's
// own caches, and each row's slot is known before its turn comes
constexpr int64_t kAhead = 16;

// every cache line of the n bytes at p
inline void fetch(const void* p, size_t n = 1) {
  const char* c = static_cast<const char*>(p);
  for (size_t o = 0; o < n; o += 64) __builtin_prefetch(c + o, 0, 3);
  __builtin_prefetch(c + n - 1, 0, 3);
}

inline int64_t home(uint64_t h, int64_t mask) {
  return static_cast<int64_t>(h & static_cast<uint64_t>(mask));
}

inline int64_t stride(uint64_t h, int64_t mask) {
  return static_cast<int64_t>(((h >> 32) << 1) | 1) & mask;
}

}  // namespace

extern "C" {

// Probes n rows.  Writes each row's hit slot or -1 into hit_slot, the hit
// rows' values in row order into hit_vals, the slots visited into
// *visited, and returns the number of hits.
int64_t rc_lookup(const uint64_t* keys, const uint8_t* vals,
                  const uint8_t* state, int64_t cap, int64_t key_words,
                  int64_t val_bytes, int64_t max_probe,
                  const uint64_t* words, const uint64_t* hashes, int64_t n,
                  int64_t* hit_slot, uint8_t* hit_vals, int64_t* visited) {
  const int64_t mask = cap - 1;
  const size_t kb = static_cast<size_t>(key_words) * 8;
  int64_t n_hit = 0, seen = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i + kAhead < n) {
      const int64_t a = home(hashes[i + kAhead], mask);
      fetch(state + a);
      fetch(keys + a * key_words, kb);
    }
    const uint64_t* w = words + i * key_words;
    int64_t s = home(hashes[i], mask);
    const int64_t step = stride(hashes[i], mask);
    int64_t found = -1;
    for (int64_t p = 0; p < max_probe; ++p) {
      ++seen;
      const uint8_t st = state[s];
      if (st == 0) break;
      if (st == 1 && same_key(keys + s * key_words, w, key_words)) {
        found = s;
        break;
      }
      s = (s + step) & mask;
    }
    hit_slot[i] = found;
    if (found >= 0) {
      std::memcpy(hit_vals + n_hit * val_bytes, vals + found * val_bytes,
                  static_cast<size_t>(val_bytes));
      ++n_hit;
    }
  }
  *visited = seen;
  return n_hit;
}

// Inserts n rows (keys words, values new_vals, model ids mids).  Returns
// the number of slots claimed; writes the tombstones among them into
// *reclaimed and the slots visited into *visited.
int64_t rc_insert(uint64_t* keys, uint8_t* vals, uint8_t* state,
                  int64_t* model, int64_t* claim, int64_t cap,
                  int64_t key_words, int64_t val_bytes, int64_t max_probe,
                  const uint64_t* words, const uint8_t* new_vals,
                  const int64_t* mids, const uint64_t* hashes, int64_t n,
                  int64_t* reclaimed, int64_t* visited) {
  const int64_t mask = cap - 1;
  const size_t vb = static_cast<size_t>(val_bytes);
  const size_t kb = static_cast<size_t>(key_words) * 8;
  std::vector<int64_t> pend(n), cur(n), step(n);
  std::vector<uint8_t> was(n), open(n);
  for (int64_t i = 0; i < n; ++i) {
    pend[i] = i;
    cur[i] = home(hashes[i], mask);
    step[i] = stride(hashes[i], mask);
  }
  int64_t admitted = 0, tombs = 0, seen = 0, np_ = n;
  for (int64_t round = 0; round < max_probe && np_ > 0; ++round) {
    seen += np_;
    // refresh matching full slots; scatter claims on the others
    for (int64_t j = 0; j < np_; ++j) {
      if (j + kAhead < np_) {
        const int64_t a = cur[pend[j + kAhead]];
        fetch(state + a);
        fetch(keys + a * key_words, kb);
        fetch(claim + a);
      }
      const int64_t i = pend[j], s = cur[i];
      const uint8_t st = state[s];
      was[j] = st;
      if (st == 1) {
        const bool hit = same_key(keys + s * key_words,
                                  words + i * key_words, key_words);
        if (hit) std::memcpy(vals + s * val_bytes, new_vals + i * vb, vb);
        open[j] = !hit;
      } else {
        claim[s] = j;
        open[j] = 1;
      }
    }
    // the winners take their slots
    for (int64_t j = 0; j < np_; ++j) {
      if (j + kAhead < np_ && was[j + kAhead] != 1) {
        const int64_t a = cur[pend[j + kAhead]];
        fetch(vals + a * val_bytes, vb);
        fetch(model + a);
      }
      if (was[j] == 1) continue;
      const int64_t i = pend[j], s = cur[i];
      if (claim[s] != j) continue;
      tombs += was[j] == 2;
      std::memcpy(keys + s * key_words, words + i * key_words, kb);
      std::memcpy(vals + s * val_bytes, new_vals + i * vb, vb);
      model[s] = mids[i];
      state[s] = 1;
      ++admitted;
      open[j] = 0;
    }
    // a loser whose slot went to its own key refreshes it
    for (int64_t j = 0; j < np_; ++j) {
      if (was[j] == 1 || !open[j]) continue;
      const int64_t i = pend[j], s = cur[i];
      if (state[s] == 1 && same_key(keys + s * key_words,
                                    words + i * key_words, key_words)) {
        std::memcpy(vals + s * val_bytes, new_vals + i * vb, vb);
        open[j] = 0;
      }
    }
    int64_t k = 0;
    for (int64_t j = 0; j < np_; ++j) {
      if (!open[j]) continue;
      const int64_t i = pend[j];
      cur[i] = (cur[i] + step[i]) & mask;
      pend[k++] = i;
    }
    np_ = k;
  }
  *reclaimed = tombs;
  *visited = seen;
  return admitted;
}

}  // extern "C"
