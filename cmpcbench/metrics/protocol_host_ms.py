"""Host milliseconds inside run_batched until it returns (no sync), the
mean over the window's calls outside the profiled stretch: the enqueue
cost that the calls kept in flight have to hide."""


def read(run):
    host = [(c["return"] - c["issue"]) * 1e3 for c in run["calls"] if not c["profiled"]]
    return sum(host) / len(host) if host else None
