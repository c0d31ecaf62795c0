"""Readings that the limits of ``portbench/limits/<cell>.json`` are set from,
in one process: the program's numbers over many seeds (short windows at the
cell's own load, each checking as many batches as a run does), and, on the
control seeds, also the control's (the reference one precision down, put in
the program's place) on the same batches:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 3 --out chiprun_out/calibrate.jsonl

Prints, per number, the largest program reading (the lower end of the
limit), the smallest control reading (the upper end) and their ratio.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from portbench import env, harness, manifest  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    env.prepare()
    spec = manifest.cell(manifest.load(), args.workload)
    seeds = [(int(s), False) for s in args.seeds.split(",") if s]
    seeds += [(int(s), True) for s in args.control_seeds.split(",") if s]
    rows = []
    with open(args.out, "a", encoding="utf-8") as out:
        for seed, control in seeds:
            t0 = time.perf_counter()
            result, run = harness.run_cell(args.workload, seed, args.seconds, False, spec=spec, control=control)
            kinds = [("program", result["checks"])] + ([("control", result["control"])] if control else [])
            for kind, checks in kinds:
                row = {"cell": args.workload, "kind": kind, "seed": seed,
                       "numbers": {k: v["value"] for k, v in checks.items()},
                       "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                       "wall_s": time.perf_counter() - t0, "device": result["device"]}
                rows.append(row)
                out.write(json.dumps(row) + "\n")
                out.flush()
                print(json.dumps(row), flush=True)
            del run
            gc.collect()
    program = [r["numbers"] for r in rows if r["kind"] == "program"]
    control = [r["numbers"] for r in rows if r["kind"] == "control"]
    for name in spec["limits"]:
        lo = max((n[name] for n in program if name in n), default=None)
        hi = min((n[name] for n in control if name in n), default=None)
        ratio = hi / lo if lo and hi is not None else None
        print(f"{args.workload} {name}: program max {lo!r}, control min {hi!r}, ratio {ratio!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
