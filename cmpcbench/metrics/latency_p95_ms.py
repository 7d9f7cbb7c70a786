"""95th percentile of every window call's latency, in one pool: from the
host clock just before its run_batched to the return of its event's
synchronize (linear interpolation between order statistics)."""
import statistics


def read(run):
    lat = [(c["done"] - c["issue"]) * 1e3 for c in run["calls"]]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100, method="inclusive")[94]
