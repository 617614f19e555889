"""Readings that set the limits of ``correct``: the program's sound runs
and the control's, several seeds in one process on the card.

    python3 portbench/control.py --workload flow16.sat_mixed8k \\
        --seeds 11,12,13 --seconds 5 --mode control

``--mode program`` runs the cell as its configuration states;
``--mode control`` runs it with the program's int8 weight lane
(``weight_bits=8, kernel_variant="int8"``), the nearest precision below
the stated int16 one.  One JSON line per seed with every number compared.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CONTROL = dict(weight_bits=8, kernel_variant="int8")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--mode", choices=("program", "control"),
                   default="control")
    args = p.parse_args(argv)

    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = bench.load_benchmark()
    workload = bench.find_workload(spec, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = bench.run(workload, spec, seed=seed, seconds=args.seconds,
                      trace=False, server_override=(
                          CONTROL if args.mode == "control" else None))
        print(json.dumps(dict(workload=args.workload, mode=args.mode,
                              seed=seed, correct=r["correct"],
                              attempted=r["attempted"],
                              checks={k: v["value"] for k, v in
                                      r["checks"].items()})), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
