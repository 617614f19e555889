"""The knee sweep of an open-loop cell: offer increasing fixed rates, one
window each, in one process on the card, and report the highest rate whose
backlog does not grow.

    python3 portbench/sweep.py --workload feat16.open_unique \\
        --rates 12000,13200,14500,16000 --seconds 10 --seed 5

A rate is sustained when its backlog does not grow: the median of how
late the client sent the chunks due in the window's last two seconds
exceeds that of the chunks due in seconds 1 to 3 by at most ``--grow-ms``
(2 ms, two drain periods).  One JSON line per rate, then the knee (the
highest rate below the first one that is not sustained; only a lower
bound when every rate offered was sustained) and 0.8 of it.  Hosts
differ: the rate written into a mix's file is 0.8 of the lowest knee its
sweeps found (PERF.md).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True,
                   help="comma-separated offered rates, packets/s")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--grow-ms", type=float, default=2.0)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = bench.load_benchmark()
    workload = bench.find_workload(spec, args.workload)
    knee, broke = None, False
    for rate in (float(r) for r in args.rates.split(",")):
        cell = bench.Cell(workload, args.seed, args.seconds,
                          mix_override={"rate_pps": rate})
        cell.warm()
        win = cell.open_loop(args.seconds)
        due, late = cell.stream.due, win["late_s"]
        end = np.median(late[due >= due[-1] - 2.0]) * 1e3
        start = np.median(late[(due >= 1.0) & (due < 3.0)]) * 1e3
        ok = end - start <= args.grow_ms
        row = dict(rate_pps=rate, sent=win["sent"],
                   done_pps=win["sent"] / (win["t1"] - win["t0"]),
                   late_median_s1to3_ms=start, late_median_last2s_ms=end,
                   late_p99_ms=bench.percentile(late, 99) * 1e3,
                   lat_p50_us=bench.percentile(win["lat_s"], 50) * 1e6,
                   lat_p99_us=bench.percentile(win["lat_s"], 99) * 1e6,
                   sustained=bool(ok))
        print(json.dumps(row), flush=True)
        broke = broke or not ok
        if not broke:
            knee = rate
        del cell
        torch.cuda.empty_cache()
    print(json.dumps(dict(workload=args.workload, knee_pps=knee,
                          knee_is_lower_bound=not broke,
                          fixed_rate_pps=None if knee is None
                          else 0.8 * knee,
                          card=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
