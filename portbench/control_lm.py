"""Readings that set the limit of an LM cell's ``correct``: the program's
sound runs and the controls', many seeds in one process on the card.

    python3 portbench/control_lm.py \\
        --workload qwen2_1_5b_w8a8.prefill_4x2k --seeds 11,12,13 \\
        --seconds 3 --modes program,int4,lsb7

``program`` runs the cell as its configuration states; ``int4`` with
4-bit weight codes from the program's own ``quantize_tree(bits=4)`` (the
nearest precision below the stated int8); ``lsb7`` with the lowest bit of
every 8-bit weight code cleared.  Each run is the whole cell (set-up, a
short window at the cell's load, the reference after it); one JSON line
per mode and seed with every number compared.  The benchmark's own runs
never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the harness is imported as the package ``portbench``: its directory,
# which holds a ``profile.py``, must not shadow the standard library
if Path(sys.path[0]).resolve() == ROOT / "portbench":
    del sys.path[0]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--modes", default="program,int4,lsb7")
    args = p.parse_args(argv)

    import torch

    from portbench import bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    spec = bench.load_benchmark()
    workload = bench.find_workload(spec, args.workload)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            r = bench.run(workload, spec, seed=seed, seconds=args.seconds,
                          trace=False, server_override=(
                              None if mode == "program"
                              else dict(control=mode)))
            print(json.dumps(dict(
                workload=args.workload, mode=mode, seed=seed,
                correct=r["correct"], attempted=r["attempted"],
                checks={k: v["value"] for k, v in r["checks"].items()},
                logit_rel_l2=r["client"]["logit_rel_l2"],
                reference_s=r["client"]["reference_s"])), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
