"""Time the ingress result cache's probe sweeps, native against plain, per
2048-row call, on the host.

    PYTHONPATH=src python3 benchmarks/pt_cache_probe.py [--out probe_ab.json]

The table is the serving cells' result cache: 2^16 slots, 17 key words
(the 136-byte wire rows of the 32-wide Table-1 packets) and 132-byte
egress values, filled with 4096, 20480 and 40960 entries.  A lookup call
probes 2048 rows of which one in eight is in the table (the feature cell's
cache hit share is ≈12.6 %); an insert call writes 2048 fresh rows into a
copy of the filled table.  Each side (``kernels.result_cache``, one native
call; ``kernels.ref``, the numpy rounds) is timed in the order native,
plain, plain, native, each reading the median of 25 calls; the mean of
each side's two readings is reported in microseconds.  Both sides must
give the same hits, values and tables, else the script exits 1.  It needs
a C++ compiler (exit 2 without one).
"""

from __future__ import annotations

import argparse
import json
import platform
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.ingress import ResultCache, hash_words  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import result_cache as rc  # noqa: E402

CAP_POW2, KEY_WORDS, VAL_BYTES, ROWS, CALLS = 16, 17, 132, 2048, 25
FILLS = (4096, 20480, 40960)


def _cpu() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def _median_us(fn, setup=tuple) -> float:
    """Median of ``CALLS`` timed calls ``fn(*setup())``, set-up untimed."""
    times = []
    for _ in range(CALLS):
        args = setup()
        t0 = time.perf_counter()
        fn(*args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def case(fill: int, rng: np.random.Generator) -> dict:
    cache = ResultCache(KEY_WORDS, VAL_BYTES, capacity_pow2=CAP_POW2)
    keys = rng.integers(0, 2 ** 63, (fill + ROWS * 2, KEY_WORDS), np.uint64)
    hashes = hash_words(keys)
    vals = rng.integers(0, 256, (fill + ROWS, VAL_BYTES), np.uint8)
    mids = np.zeros(fill + ROWS, np.int64)
    cache.insert(keys[:fill], vals[:fill], mids[:fill], 0, hashes[:fill],
                 assume_unique=True)
    table = (cache._keys, cache._vals, cache._state, cache._model,
             cache._claim)
    # lookups: one row in eight in the table, the rest absent
    hit = rng.random(ROWS) < 0.125
    pick = np.where(hit, rng.integers(0, fill, ROWS),
                    fill + ROWS + np.arange(ROWS))
    q_words, q_hash = keys[pick], hashes[pick]
    new = slice(fill, fill + ROWS)
    sides = {"native": rc.sweeps(),
             "plain": (ref.result_cache_lookup_ref,
                       ref.result_cache_insert_ref)}
    out, seen = {}, {}
    for side in ("native", "plain", "plain", "native"):
        lookup, insert = sides[side]
        slot = np.empty(ROWS, np.int64)
        got = np.empty((ROWS, VAL_BYTES), np.uint8)

        def do_lookup():
            return lookup(table[0], table[1], table[2], 32, q_words, q_hash,
                          slot, got)

        def do_insert(*copy):
            insert(*copy, 32, keys[new], vals[new], mids[new], hashes[new])
            return copy

        n_hit, _ = do_lookup()
        after = do_insert(*(a.copy() for a in table))
        seen.setdefault(side, (slot.copy(), got[:n_hit].copy(), after))
        t_insert = _median_us(do_insert,
                              lambda: tuple(a.copy() for a in table))
        out.setdefault(side, {"lookup_us": [], "insert_us": []})
        out[side]["lookup_us"].append(_median_us(do_lookup))
        out[side]["insert_us"].append(t_insert)
    a, b = seen["native"], seen["plain"]
    same = (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
            and all(np.array_equal(x, y) for x, y in zip(a[2], b[2])))
    res = {side: {k: statistics.mean(v) for k, v in t.items()}
           for side, t in out.items()}
    return dict(fill=fill, hits=int((a[0] >= 0).sum()), same=same, **res,
                lookup_speedup=res["plain"]["lookup_us"]
                / res["native"]["lookup_us"],
                insert_speedup=res["plain"]["insert_us"]
                / res["native"]["insert_us"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the result object here")
    args = ap.parse_args()
    if rc.sweeps() is None:
        print("no C++ compiler: nothing to compare", file=sys.stderr)
        return 2
    rng = np.random.default_rng(20260)
    cases = [case(fill, rng) for fill in FILLS]
    for c in cases:
        print(json.dumps(c))
    result = dict(ok=all(c["same"] for c in cases), host=_cpu(),
                  rows=ROWS, capacity=1 << CAP_POW2, key_words=KEY_WORDS,
                  cases=cases)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps({k: v for k, v in result.items() if k != "cases"}))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
