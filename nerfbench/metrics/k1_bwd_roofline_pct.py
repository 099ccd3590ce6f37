"""k1_bwd_roofline_pct: the brick-grid calls' least backward time
(``counts/grids.py``) over the device time of K1 backward
(``brickgrid_backward_kernel``), per iteration, in %."""

from nerfbench.metrics._common import roofline_pct


def read(tr):
    if tr is None or tr["kind"] != "train":
        return None
    return roofline_pct(tr, True, True, "brickgrid_backward_kernel")
