"""k1_fwd_roofline_pct.eval: the brick-grid calls' least forward time
(``counts/grids.py``) over the device time of K1 forward
(``brickgrid_encode_kernel``), per eval frame, in %."""

from nerfbench.metrics._common import roofline_pct


def read(tr):
    if tr is None or tr["kind"] != "eval":
        return None
    return roofline_pct(tr, True, False, "brickgrid_encode_kernel")
