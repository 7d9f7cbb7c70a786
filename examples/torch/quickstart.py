"""Quickstart on the PyTorch port: privacy-preserving matrix
multiplication with AGE-CMPC.

Two sources hold private matrices A and B; N edge workers compute
Y = A^T B without any z-subset of them (or the master) learning the
inputs.  The counterpart of ``examples/quickstart.py``, with the same
asserts.  Run (on the GPU, or ``--device cpu``):

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import closed_form as cf
from repro_torch.core import constructions as C
from repro_torch.core import protocol
from repro_torch.core.constructions import PlanConfig
from repro_torch.core.gf import Field
from repro_torch.core.layers import secure_matmul, secure_matmul_batched
from repro_torch.core.planner import BlockShapes, get_plan_for, plan_cache_info


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="the device (default: the GPU)")
    args = ap.parse_args(argv)
    device = protocol.resolve_device(args.device)
    s, t, z = 2, 2, 2  # partitions + collusion tolerance (paper Example 1)

    print(f"=== worker counts (s=2, t=2, z=2) on {device} ===")
    print(f"AGE-CMPC      : {cf.n_age_exact(s, t, z)[0]} workers (lambda* = {cf.n_age_exact(s, t, z)[1]})")
    print(f"PolyDot-CMPC  : {C.polydot_cmpc(s, t, z).n_workers}")
    print(f"Entangled-CMPC: {cf.n_entangled(s, t, z)}")
    print(f"SSMM          : {cf.n_ssmm(s, t, z)}")
    print(f"GCSA-NA       : {cf.n_gcsa_na(s, t, z)}")

    # --- exact field computation --------------------------------------
    field = Field()
    rng = np.random.default_rng(0)
    m = 64
    a = field.random(rng, (m, m))
    b = field.random(rng, (m, m))
    config = PlanConfig("age", s=s, t=t, z=z, n_spare=2)
    plan = get_plan_for(config, BlockShapes(k=m, ma=m, mb=m, s=s, t=t))
    y, trace = protocol.run(plan, a, b, device=device)
    assert np.array_equal(y, field.matmul(a.T, b))
    pred = cf.predict(config, m)
    print(f"\nGF(p) protocol [{config.label()}]: N={plan.n_workers} "
          f"(+{config.n_spare} spares), exact result verified; "
          f"{trace.total:,} field elements moved "
          f"(closed form: {pred.comm:,} across all phases)")

    # --- batched device-resident engine -------------------------------
    batch = 8
    ab = field.random(rng, (batch, m, m))
    bb = field.random(rng, (batch, m, m))
    yb, traceb = protocol.run_batched(plan, ab, bb, device=device)
    yb = yb.cpu().numpy()
    for i in range(batch):
        assert np.array_equal(yb[i], field.matmul(ab[i].T, bb[i]))
    print(f"batched protocol: {batch} products in one device pipeline, "
          f"exact; {traceb.total:,} field elements moved")

    # --- real-valued wrapper ------------------------------------------
    x = rng.normal(size=(32, 16))
    w = rng.normal(size=(32, 8))
    res = secure_matmul(x, w, s=s, t=t, z=z, device=device)
    err = np.abs(res.y.cpu().numpy() - x.T @ w).max()
    print(f"real-valued secure_matmul: max |err| = {err:.4f} (fixed-point)")

    # --- batched real-valued wrapper (one weight, many activations) ---
    xs = rng.normal(size=(batch, 32, 16))
    resb = secure_matmul_batched(xs, w, s=s, t=t, z=z, device=device)
    yb = resb.y.cpu().numpy()
    errb = max(np.abs(yb[i] - xs[i].T @ w).max() for i in range(batch))
    ci = plan_cache_info()
    print(f"batched secure_matmul: max |err| = {errb:.4f}; "
          f"plan cache: {ci['hits']} hits / {ci['misses']} misses")


if __name__ == "__main__":
    main()
