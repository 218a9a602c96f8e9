"""The benchmark of the PyTorch port: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Prints, last on standard output, one JSON line: ``correct``,
``attempted`` and ``failed`` (the window's steps, and those whose loss
was not finite), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` the
``breakdown``, and last ``checks``: each number compared with the
reference beside its limit, which also close standard error.  Exits
non-zero, printing no result, without a CUDA device (or with fewer than
the cell asks for) or where the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
CACHE = CHECKOUT / ".bench_cache"
#: top-level modules a run of the port must not load: JAX and the JAX
#: package the port was made from (``repro_torch`` is not ``repro``)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of the run inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]

    import torch

    from perfbench import harness

    # the program drives the card from one thread; no CPU op of the step
    # needs more, and idle worker threads only contend with it
    torch.set_num_threads(1)

    bench = harness.load_json(CHECKOUT / "BENCHMARK.json")
    cell = harness.load_cell(args.workload, bench)
    chips = {w["name"]: w for w in bench["workloads"]}[args.workload]["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell asks for "
              f"{chips}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START,
                              log=lambda line: print(line, file=sys.stderr))
    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"the run loaded {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
