"""cmpcbench: one run of one cell of the port's benchmark.

    python3 cmpcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell
asks for.  Prints the run's result as the last line of standard output
(one JSON object), and the numbers the check compared, each beside its
limit, as the last lines of standard error.  Exits non-zero with no
result where there is no CUDA card, too few cards, or a module of JAX or
of the JAX package loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build of the program at a fixed path inside the checkout, so
    # that only a checkout's first run compiles
    build = ROOT / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from cmpcbench import harness

    chips = {w["name"]: w["chips"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START, device=device)
    found = harness.forbidden_modules()
    if found:
        print(f"import check: {', '.join(found)} loaded in this process", file=sys.stderr)
        return 3
    print(f"import check: none of {', '.join(sorted(harness.FORBIDDEN))} among the "
          f"{len(sys.modules)} modules loaded (top-level names compared whole)", file=sys.stderr)
    for name, c in result["checks"].items():
        limit = f">= {c['min']}" if "min" in c else f"<= {c['max']}"
        print(f"check {name}: {c['value']} (limit {limit})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
