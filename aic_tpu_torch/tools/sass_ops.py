#!/usr/bin/env python3
"""Count a kernel's operations per branch from its SASS, for
`chip_smoke.OPS`.

    /usr/local/cuda/bin/cuobjdump -sass aic_tpu_torch/_build/libtrace-*.so > trace.sass
    python3 aic_tpu_torch/tools/sass_ops.py trace.sass steps=1a40-1c00 classify=1fe0-22a0! ...

Each argument names a branch count and the instruction addresses (hex, as
the dump prints them) that one unit of it runs: ranges joined by `+`.
An instruction counts one if it is an arithmetic, compare, logic, shift,
min/max, conversion, select or special-function instruction, table index
arithmetic included; loads, stores, constant loads, moves, branches,
barriers and calls (a division's slow path) count none. A range marked
`!` holds both sides of a choice predicated on one flag (`@P1` / `@!P1`,
such as a narrow or a wide classify page): only the shorter side counts.
Prints one JSON object, the count for each name. Runs anywhere: it reads
a dump made on the card.
"""

from __future__ import annotations

import json
import re
import sys

NOT_OPS = ("LDG", "STG", "LDC", "ULDC", "MOV", "IMAD.MOV", "BRA", "BREAK", "BSSY", "BSYNC", "EXIT",
           "P2R", "R2P", "HFMA2.MMA", "WARPSYNC", "CALL", "RET", "NOP", "S2R", "CS2R")
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?P\d\s+)?(\S+)\s*(.*?);")


def parse(path: str) -> list:
    """(address, predicate, opcode, operands) of each instruction."""
    out = []
    with open(path) as f:
        for ln in f:
            m = LINE.search(ln)
            if m:
                out.append((int(m.group(1), 16), (m.group(2) or "").strip(), m.group(3), m.group(4)))
    return out


def is_op(op: str, args: str) -> bool:
    if any(op == n or op.startswith(n + ".") for n in NOT_OPS):
        return False
    # `IADD3 Rd, Ra, RZ, RZ` is a register move.
    return not (op == "IADD3" and re.fullmatch(r"R\d+, R\d+, RZ, RZ", args.strip()))


def count(instrs: list, lo: int, hi: int, shorter_side: bool) -> int:
    plain, sides = 0, {}
    for addr, pred, op, args in instrs:
        if lo <= addr <= hi and is_op(op, args):
            if shorter_side and pred:
                flag = pred.lstrip("@!")
                pos, neg = sides.setdefault(flag, [0, 0])
                sides[flag] = [pos, neg + 1] if pred.startswith("@!") else [pos + 1, neg]
            else:
                plain += 1
    return plain + sum(min(pos, neg) for pos, neg in sides.values())


def main() -> None:
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    instrs = parse(sys.argv[1])
    counts = {}
    for spec in sys.argv[2:]:
        name, ranges = spec.split("=", 1)
        total = 0
        for r in ranges.split("+"):
            shorter = r.endswith("!")
            lo, hi = (int(x, 16) for x in r.rstrip("!").split("-"))
            total += count(instrs, lo, hi, shorter)
        counts[name] = total
    print(json.dumps(counts))


if __name__ == "__main__":
    main()
