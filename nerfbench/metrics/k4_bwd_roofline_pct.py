"""k4_bwd_roofline_pct: the hash-grid calls' least backward time
(``counts/grids.py``) over the device time of K4 backward
(``hashgrid_backward_kernel``), per iteration, in %."""

from nerfbench.metrics._common import roofline_pct


def read(tr):
    if tr is None or tr["kind"] != "train":
        return None
    return roofline_pct(tr, False, True, "hashgrid_backward_kernel")
