#!/usr/bin/env python
"""Prints the shares of the device time that ``chip_smoke.py`` reads from
a training profile (the grid kernels, the transposes, and copies, casts and
fills), for each profile JSON that ``chip_smoke.py`` phase 5 or 6 wrote
(``chiprun_out/profile_train*.json``), e.g. another checkout's, so that two
checkouts' profiles from one chip call are read the same way:

    python -m emernerf_torch.perf.profile_shares chiprun_out/profile_train.json [...]

It needs no card: it reads the files.
"""

from __future__ import annotations

import json
import sys


def main(argv=None):
    import chip_smoke as cs

    for path in (sys.argv[1:] if argv is None else argv):
        with open(path) as f:
            prof = json.load(f)
        busy = prof["busy_ms_per_iteration"]
        # chip_smoke's rows are (name, ms over 2 iterations, count)
        rows = [(r["name"], 2 * r["ms_per_iteration"], 2 * r["count"]) for r in prof["rows"]]
        shares = cs.profile_shares(rows, busy)
        print(f"{path}: device busy {busy:.3f} ms per iteration, "
              f"{prof['ms_per_iteration']:.2f} ms per iteration unprofiled")
        for what, share in shares.items():
            print(f"  {what}: {share:.1%}, {share * busy:.3f} ms per iteration")
        print(json.dumps({"profile": path, "busy_ms": busy, "shares": shares}))


if __name__ == "__main__":
    main()
