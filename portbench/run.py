"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  Prints the result as the last line of
standard output, one JSON object, and the numbers the check compared,
each beside its limit, as the last lines of standard error.  Exits
non-zero, with no result, without a CUDA card (or with fewer than the
cell asks for), and where JAX or the JAX package is loaded once the
window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    _, cell, _, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, code, lines = harness.run(
        args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    for line in lines:
        print(line, file=sys.stderr)
    if result is not None:
        sys.stdout.flush()
        print(json.dumps(result))
    return code


if __name__ == "__main__":
    sys.exit(main())
