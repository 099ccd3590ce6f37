#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``emernerf_torch`` on the card.

    python3 nerfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads ``nerfbench/workloads/<cell>.json`` and the configuration it names,
builds the program from the seed on the card, warms up the cell's shapes,
measures for ``--seconds`` and checks what the timed path produced against
the plain reference.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and, with
``--trace 1``, ``breakdown``); the numbers compared, each beside its limit,
are the last lines of standard error.  See ``nerfbench/README.md``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process, few threads: the host's thread pools stay out of the way of
# the thread that launches the kernels
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from nerfbench import harness

    harness.pin_caches(ROOT)
    return harness.run(args, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
