"""Runs one cell of the benchmark once and prints its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in BENCHMARK.json; everything it
names is found by name under ``bench/`` (see ``harness/spec.py``). The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number the check compared beside its limit; the same numbers are the
last lines of standard error. Without a CUDA card, or with fewer cards
than the cell asks for, it exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the program stays at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT / "src"))

#: top-level modules the process must not hold when it reports: the
#: JAX stack and the JAX package ("repro"; "repro_torch" is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed is a non-negative whole number")

    from harness import spec as SPEC
    cell = SPEC.load_cell(args.workload)
    # the configuration's host threads, set before the numerical
    # libraries start their pools
    threads = str(int(cell.config["host_threads"]))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = threads
    import torch
    from harness import drive
    torch.set_num_threads(int(threads))

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out, values = drive.run(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"the process holds {found}: the benchmark must run without "
              f"JAX and the JAX package", file=sys.stderr)
        return 3
    out = drive.finish(out, values, cell.limits)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
