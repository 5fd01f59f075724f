"""The readings that the data-parallel cell's limits are set from, on the cards.

    python3 portbench/calibrate_dp.py --workload train-s64-dp4x12 --seeds 1,2,3 \
        --as program|control|rank_short|no_allreduce

One launch of the cell's ranks for all the seeds, each seed's set-up
steps, a window of ``--seconds`` and the reference, then one JSON line a
seed with the numbers compared and the calibration's detail:
  program     the port as the benchmark runs it: the lower readings
  control     the plain reference with the global batch's BatchNorm in the
              program's place, every product in fp8 (``control.py``): the
              upper readings
  rank_short  a fault: the program with its averages over the ranks
              (the gradients' and the metrics') counting one rank short
  no_allreduce  a fault: the program with its gradient all-reduce left
              out, so each rank steps on its own share's gradient
``calibrate.py`` does the same for the one-process cells.  The
benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from portbench import harness  # noqa: E402
from portbench.drivers import train_dp  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--as", dest="mode", default="program",
                    choices=("program", "control", "rank_short", "no_allreduce"))
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    bench, cell, config, traffic = harness.load_cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    seeds = [int(s) for s in args.seeds.split(",")]
    ctx = harness.Context(workload=cell["name"], seed=seeds[0], seconds=args.seconds, trace=False, cell=cell,
                          config=config, traffic=traffic, device=device, t0=time.perf_counter(), log=harness.log)
    t = time.perf_counter()
    for seed, got in zip(seeds, train_dp.run(ctx, mode=args.mode, seeds=seeds)):
        detail = {}
        checks = train_dp.compare(ctx, got["prog"], got["ref"], detail=detail)
        print(json.dumps({"workload": cell["name"], "as": args.mode, "seed": seed, "checks": checks,
                          "detail": detail, "attempted": got["rec"]["steps"], "failed": got["failed"],
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
