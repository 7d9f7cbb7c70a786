"""Set-up: from the first statement of run.py to the first timed call
(imports, the kernel library, the weight from the seed, the plan, the
warm calls)."""


def read(run):
    return run["setup_s"]
