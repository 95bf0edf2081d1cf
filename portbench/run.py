"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared beside its limit); the numbers compared also close standard
error. Exits with another code than 0, printing no result, without a
CUDA device or with fewer than the cell asks for, or when JAX or the JAX
package is loaded.

``setup_s`` starts once torch is imported and the card's CUDA context
made, which no change of the program can shorten; standard error gives
that time apart.
"""

import time

T0 = time.time()  # process start, as near as the script can take it

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    why = harness.cuda_ready(int(cell.entry.get("chips", 1)))
    if why:
        print(f"no run: {why}", file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t_env = time.time()
    run, line = harness.run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda", t0=t_env)
    print(f"interpreter, torch import and CUDA context "
          f"{t_env - T0:.3f} s (not in setup_s)", file=sys.stderr)
    for note in run.notes:
        print(note, file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
