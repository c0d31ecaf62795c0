"""Runs one cell of ``BENCHMARK.json`` once and prints its result as the
last line of standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero without a result when CUDA is missing or has fewer cards
than the cell asks for, and when the process holds JAX or the JAX package
once the window has closed. The numbers that decide ``correct`` are
printed, each beside its limit, as the last lines of standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(REPO))
    from portbench import env, harness, manifest

    env.prepare()

    spec = manifest.cell(manifest.load(), args.workload)
    import torch

    need = int(spec["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, _ = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START, spec=spec)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)} after the window; no result", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
