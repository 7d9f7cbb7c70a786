"""The products the compiled kernels launched per product the calls
needed, over the profiled stretch: Σ 2·B·M·K·N over every launch in the
program's launch shapes (``kernel.LAUNCH_SHAPES_BY_KERNEL``, every
compiled kernel) over Σ of the profiled calls' operations (the
reference's ``work``).  It rises with the coding's work per product, with
an expert batch's padding and with a weight shared more than once."""


def launched_ops(launch_shapes) -> int:
    """Σ 2·B·M·K·N of ``launch_shapes`` ({kernel: [[B, M, K, N, launches], ...]})."""
    return sum(2 * b * m * k * n * count
               for shapes in launch_shapes.values() for b, m, k, n, count in shapes)


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    needed = sum(c["ops"] for c in run["calls"] if c.get("profiled"))
    launched = launched_ops(tr["launch_shapes"])
    return launched / needed if needed and launched else None
