"""Launches of the compiled modular matmul kernels per call, from the
program's counters (kernel.LAUNCHES_BY_KERNEL) over the profiled stretch."""


def read(run):
    tr = run["trace"]
    if not tr or not tr["calls"]:
        return None
    total = sum(tr["launches"].values())
    return total / tr["calls"] if total else None
