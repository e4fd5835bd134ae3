#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the CUDA card(s) of this
machine, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the numbers that decide ``correct`` beside their limits as the
last lines of standard error, and one JSON object as the last line of
standard output.  Without enough CUDA devices it exits non-zero and
prints no result; it never falls back to the CPU.
"""

import time

# Set-up is timed from here, before anything heavy is imported.
T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    # The checkout's root, not this folder, heads the path: a module here
    # must never shadow one of the standard library.
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path[0] = ROOT
    elif ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.main(sys.argv[1:] if argv is None else argv, T0, ROOT)


if __name__ == "__main__":
    sys.exit(main())
