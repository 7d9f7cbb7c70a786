"""Device milliseconds per call of every operation that run_batched
launched and that is not a kernel of the modular matmul library (block
permutes and scatters, remainder, index_select, random secrets, mod_add,
the int64 cast), over the profiled stretch."""

from cmpcbench.roofline import LIBRARY


def read(run):
    tr = run["trace"]
    if not tr or not tr["calls"]:
        return None
    ops = [o for o in tr["device"] if o[3] == "run_batched" and LIBRARY not in o[0]]
    if not ops:
        return None
    return sum(e - s for _, s, e, _ in ops) / 1e6 / tr["calls"]
