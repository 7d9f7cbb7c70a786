"""Tokens secured per second: the tokens (batch x ma) of every call
completed in the window over the window's seconds (first issue to the
last completion, host clock)."""


def read(run):
    if not run["calls"] or run["window_s"] <= 0:
        return None
    return sum(c["tokens"] for c in run["calls"]) / run["window_s"]
