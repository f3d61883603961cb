"""Readings the limits of ``correct`` are set from (see PERF.md), at a
cell's own sizes on the card, many seeds in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 12 \
        --control-seeds 3 --fault-seeds 3 --seconds 2 --out <file.json>

For each of ``--seeds`` seeds (from ``--seed0`` on): the cell's set-up, a
short window of calls (``--seconds``), then the numbers compared with the
reference, as a run makes them. On the first ``--control-seeds`` seeds
also the control: the reference in bfloat16 in the program's place
(``--control-compare`` answers or classifiers). On the first
``--fault-seeds`` seeds each fault of portbench/faults.py (or those
``--faults`` names), planted under the timed path. Every reading is printed as a JSON line and written to
``--out``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import drive, faults
from .reference import judge
from .run import load_json


def reading(cfg, mix, seed, seconds, program=None, control=False,
            n=None, device="cuda"):
    drv = drive.driver(cfg, mix, seed, device, program)
    t0 = time.perf_counter()
    drv.setup()
    drv.window(seconds)
    calls = [c[1] - c[0] for c in drv.calls]
    drv.release()
    t1 = time.perf_counter()
    nums = drv.check(n or mix["compare"], judge,
                     torch.bfloat16 if control else None)
    return nums, t1 - t0, time.perf_counter() - t1, calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--seed0", type=int, default=2**31 + 7)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--control-compare", type=int, default=None)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--faults", default=None,
                    help="comma-separated faults (default: every one the "
                    "kind can have)")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    bench = load_json("BENCHMARK.json")
    wl = next(w for w in bench["workloads"] if w["name"] == args.workload)
    cfg = load_json("portbench", "configs", f"{wl['config']}.json")
    mix = load_json("portbench", "traffic", f"{wl['traffic']}.json")
    rows = []

    def emit(**row):
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)

    for k in range(args.seeds):
        seed = args.seed0 + 7919 * k
        nums, run_s, check_s, calls = reading(cfg, mix, seed, args.seconds)
        emit(kind="program", seed=seed, numbers=nums, run_s=run_s,
             check_s=check_s, call_s=calls)
        if k < args.control_seeds:
            nums, _, check_s, _ = reading(cfg, mix, seed, 0.0, control=True,
                                          n=args.control_compare)
            emit(kind="control", seed=seed, numbers=nums, check_s=check_s)
        if k < args.fault_seeds:
            names = (args.faults.split(",") if args.faults
                     else getattr(faults, mix["kind"].upper()))
            for name in names:
                prog = faults.KINDS[mix["kind"]](name)
                nums, _, check_s, _ = reading(cfg, mix, seed, 0.0,
                                              program=prog)
                emit(kind=f"fault:{name}", seed=seed, numbers=nums,
                     check_s=check_s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
