"""The plain product's operations (2 * batch * k * ma * mb a call) over
the calls completed in the whole traced window, per second, as a share
of the card's int8 peak (roofline.py)."""
from cmpcbench import roofline


def read(run):
    if not run["calls"] or run["window_s"] <= 0:
        return None
    ops = sum(c["ops"] for c in run["calls"])
    return 100.0 * ops / run["window_s"] / roofline.PEAK_OPS_PER_S
