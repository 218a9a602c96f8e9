"""The control of a cell's comparison: the plain reference put in the
program's place and computed one precision below the cells' f32 with
TF32 off, that is with TF32 products, then compared with the f32
reference as a run of the program is.  The comparison has to find it
not correct, or it cannot tell a sound run from one in lower precision.

    python3 perfbench/control.py --workload <name> --seed <n> [--seed <n> ...]

prints one JSON line a seed: the numbers compared and whether they pass
the cell's limits.  It runs on the card only (TF32 is a card mode).
"""

import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent


def control_numbers(cell, seed: int, device) -> dict:
    from perfbench import harness
    from perfbench.reference.train import readings

    ref = readings(cell.family, cell.config, cell.traffic, seed, device,
                   harness.CHECKED_STEPS)
    low = readings(cell.family, cell.config, cell.traffic, seed, device,
                   harness.CHECKED_STEPS, tf32=True)
    return harness.compare(low, ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("no CUDA device: TF32 is a card mode", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in args.seed:
        numbers = control_numbers(cell, seed, torch.device("cuda"))
        passed = all(v <= cell.limits[k] for k, v in numbers.items()
                     if cell.limits[k] is not None)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "numbers": numbers, "passes_limits": passed}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
