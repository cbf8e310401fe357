"""Read the check's numbers of the program and of its control on several
seeds of one cell, in one process: the readings each limit is set from.

    python3 voxbench/control.py --workload atrium.relight --seconds 5 --seeds 11,12,13 \\
        --out control.jsonl

Each seed is one run of the cell (set-up, a window of `--seconds`, the
check), then the control: the plain reference one precision step down put
in the program's place and judged by the same comparison. One JSON line
a seed: the program's numbers (`checks`) and the control's (`control`).
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from voxbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--no-control", action="store_true", help="the program's numbers only")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    harness.require_chips(cell.chips)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(cell, seed, args.seconds, False, control=not args.no_control)
        line = {"workload": args.workload, "seed": seed, "attempted": r["attempted"],
                "metrics": r["metrics"], "reference_s": r["reference_s"], "checks": r["checks"],
                "control": r.get("control"), "unit_ms": r["unit_ms"], "diagnostics": r["diagnostics"]}
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
