"""Share of the profiled stretch in which no operation runs on the card
(the union of the device operations' intervals, against the stretch
between its two synchronizations)."""
from cmpcbench import trace


def read(run):
    tr = run["trace"]
    if not tr or not tr["device"]:
        return None
    w0, w1 = tr["window_ns"]
    busy = sum(e - s for s, e in trace.busy_intervals(tr["device"], w0, w1))
    return 100.0 * (1.0 - busy / (w1 - w0))
