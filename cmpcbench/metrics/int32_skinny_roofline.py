"""Share of its roofline that the compiled `int32_skinny` kernel reaches over
the profiled stretch, plain and masked forms together (roofline.py)."""
from cmpcbench import roofline


def read(run):
    return roofline.kernel_share(run["trace"], "int32_skinny")
