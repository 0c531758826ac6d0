"""Readings that set the limits of a cell's checks: in one process, the
cell's set-up once, then for each seed a window of the cell's own
traffic, the numbers the benchmark compares, and the same numbers of the
control (the reference in the program's place, at 8-bit saturating
scores and float32 posteriors; and at float32 posteriors alone), and
with `--faults` the numbers of the program with each fault of
`harness/faults.py` planted under its timed path.  A cell over several
cards runs whole for each seed (`harness/ranks.py`).  The benchmark's
runs never run this.

    python3 portbench/readings.py --workload cs-unpaired \\
        --seconds 20 --seeds 11 12 13 --faults k7_crossover k7_gap
"""

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness import cell as cellmod  # noqa: E402
from harness import core as harness  # noqa: E402
from harness import faults  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    args = ap.parse_args(argv)
    cell = cellmod.load_cell(args.workload)
    harness.pin_threads(int(cell.config["host_threads"]))
    harness.cache_dirs(cell.root)
    import torch
    if not torch.cuda.is_available():
        harness.log("portbench readings: no CUDA device")
        return 2
    torch.set_num_threads(int(cell.config["host_threads"]))
    if cell.chips > 1:
        return rank_readings(cell, args)
    run = harness.Run(cell, args.seeds[0], args.seconds, False, "cuda",
                      T_START)
    run.prepare_program()
    for seed in args.seeds:
        run.prepare_pool(seed)
        run.drive()
        reads, rate = (run.record["reads"],
                       run.record["reads"] / run.record["window_s"])
        t = time.perf_counter()
        r = run.readings()
        check_s = time.perf_counter() - t
        for name in args.faults:
            with faults.planted(name):
                run.drive()
            r[name] = run.judge_numbers()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reads": reads, "reads_per_s": rate,
                          "check_s": check_s, **r}), flush=True)
    return 0


def rank_readings(cell, args) -> int:
    """A cell over ranks: for each seed a whole run (the ranks' set-up
    is theirs), then the numbers of the program and of the controls on
    the window's sample."""
    from harness import ranks
    if args.faults:
        harness.log("portbench readings: the planted faults are colour "
                    "space's, on one card")
        return 2
    for seed in args.seeds:
        launch = ranks.Launch(cell, seed, args.seconds, False, "cuda",
                              time.perf_counter())
        launch.prepare()
        launch.run()
        rec = launch.record
        t = time.perf_counter()
        r = launch.readings()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "reads": rec["reads"],
                          "reads_per_s": rec["reads"] / rec["window_s"],
                          "check_s": time.perf_counter() - t, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
