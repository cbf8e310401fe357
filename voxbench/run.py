"""Run one cell of the benchmark once.

    python3 voxbench/run.py --workload atrium.relight --seed 7 --seconds 51 --trace 0

prints, as the last line of its standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `checks`: each number compared with its limit, also
written as the last lines of standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it
prints no result and exits 2. `--rehearse-cpu` runs the same code on the
CPU (the program's plain twins) at a size the overrides give, writes its
line to standard error only and exits 3: a rehearsal is never a
measurement.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on the CPU at a small size; prints no result")
    ap.add_argument("--override", action="append", default=[], metavar="KEY=JSON",
                    help="with --rehearse-cpu: a traffic parameter or 'world' replaced")
    args = ap.parse_args(argv)

    from voxbench import harness

    cell = harness.find_cell(args.workload)
    overrides = {}
    if args.rehearse_cpu:
        for kv in args.override:
            k, v = kv.split("=", 1)
            overrides[k] = json.loads(v)
        device = "cpu"
    else:
        if args.override:
            print("--override is for --rehearse-cpu only", file=sys.stderr)
            return 2
        try:
            harness.require_chips(cell.chips)
        except harness.NoChip as e:
            print(f"voxbench: {e}", file=sys.stderr)
            return 2
        device = "cuda"

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device=device,
                              overrides=overrides, t_start=T_START)
    found = harness.forbidden_loaded()
    if found:
        print(f"voxbench: forbidden modules loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = json.dumps(result)
    if args.rehearse_cpu:
        print(f"REHEARSAL (CPU, not a measurement): {line}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
