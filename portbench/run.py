"""Run one cell of the port's benchmark on the card it is started on.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and per-layer readers are found by
the names in ``BENCHMARK.json``.  The last line of standard output is the
result object; the numbers compared with the reference, each beside its
limit, are the last lines of standard error.  The run refuses to start
without enough cards, and prints no result if JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the harness is imported as the package ``portbench``: its directory,
# which holds a ``profile.py``, must not shadow the standard library
if Path(sys.path[0]).resolve() == ROOT / "portbench":
    del sys.path[0]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import bench

    t_import = time.perf_counter()
    spec = bench.load_benchmark()
    workload = bench.find_workload(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < workload["chips"]:
        print(f"needs {workload['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    marks = dict(import_s=t_import - T_START,
                 cuda_init_s=time.perf_counter() - t_import)
    result = bench.run(workload, spec, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), t_start=T_START, marks=marks)
    bad = bench.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
