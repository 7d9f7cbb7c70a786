"""The dry-run's torch form (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``: the sweep's cells and skip records,
the CLI, and reduced train cells traced on a fake process group against
the same step on 4 real gloo ranks and against the reference's compiled
step on 4 host devices.

What is compared, each with its reason:

* cells, skip records and the applicability count: equal (the same
  tables);
* collective counts and bytes by kind: equal to the real step's on 4
  gloo ranks under ``comm.CollectiveLog`` (the trace runs the same code);
* argument bytes a rank: equal to the reference's
  ``memory_analysis().argument_size_in_bytes`` (the spec tables are
  equal, so each rank holds the same shards);
* FLOPs a rank: within 5% of the reference's loop-aware walker
  (``hlo_cost.analyze``) on its compiled step -- XLA's and the port's
  products differ where one replicates what the other splits (observed
  ratios in PERF.md).
"""
import dataclasses
import json
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_ranks import run_ranks

REDUCED = ("minicpm-2b", "zamba2-2.7b")  # a dense and a hybrid cell
SEQ, GB = 32, 8
FLOPS_RTOL = 0.05


def _cfg(arch):
    from repro_torch import configs

    return configs.reduced(configs.get_config(arch))


def _shape(seq=SEQ, b=GB):
    from repro_torch.configs import SHAPES

    return dataclasses.replace(SHAPES["train_4k"], seq_len=seq, global_batch=b)


def _cell(arch, mesh_dims=((2, 2), ("data", "model")), shape=None, mesh_kind="single"):
    from repro_torch.launch import dryrun

    return dryrun.run_cell(arch, "train_4k", mesh_kind, verbose=False, cfg=_cfg(arch),
                           shape=shape or _shape(), mesh_dims=mesh_dims)


# ----------------------------------------------------------------------
# the real step on 4 gloo ranks
# ----------------------------------------------------------------------
def step_job(_, archs, batches):
    from repro_torch.distributed import comm
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import adamw_init

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {}
    for arch in archs:
        model = build_model(_cfg(arch), device="cpu", train=True, mesh=mesh)
        bundle = steps.build_train_step(model, mesh, _shape())
        params = model.params()
        opt = adamw_init(params, bundle.opt_cfg)
        with comm.CollectiveLog() as log:
            bundle(params, opt, batches[arch])
        out[arch] = {"counts": dict(log.counts), "sent": dict(log.sent),
                     "input_bytes": dict(log.input_bytes)}
    return out


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------
REF = """
import dataclasses, pickle, sys
import jax
jax.devices()  # four host devices, before repro.launch.dryrun sets its own flag
from repro.configs import SHAPES, get_config, reduced
from repro.launch import dryrun, hlo_cost
from repro.launch.mesh import make_mesh
from repro.launch.steps import build_train_step
from repro.models import build_model

inp = pickle.load(open(sys.argv[1], "rb"))
out = {"cells": list(dryrun.cells("all", "all", "both")), "skips": {}, "cost": {}}
for arch, shape, mesh in out["cells"]:
    rec = dryrun.run_cell(arch, shape, mesh, verbose=False) if (arch, shape) in inp["skip"] else None
    if rec is not None:
        out["skips"][(arch, shape, mesh)] = rec
mesh = make_mesh((2, 2), ("data", "model"))
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=inp["seq"], global_batch=inp["gb"])
for arch in inp["archs"]:
    bundle = build_train_step(build_model(reduced(get_config(arch))), mesh, shape)
    with mesh:
        compiled = bundle.lower().compile()
    out["cost"][arch] = {
        "argument_size_in_bytes": compiled.memory_analysis().argument_size_in_bytes,
        "flops": hlo_cost.analyze(compiled.as_text()).flops}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from _subproc import subprocess_env
    from repro_torch import configs
    from repro_torch.launch import dryrun

    tmp = tmp_path_factory.mktemp("dryrun")
    skip = [(a, s) for a in configs.ARCH_NAMES for s in configs.SHAPES
            if not configs.shape_applicable(configs.get_config(a), configs.SHAPES[s])]
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump({"archs": REDUCED, "seq": SEQ, "gb": GB, "skip": skip}, f)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF), str(tmp / "ref_in.pkl"),
         str(tmp / "ref_out.pkl")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=subprocess_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"), cwd=".")
    rng = np.random.default_rng(3)
    batches = {a: {k: rng.integers(0, 256, (GB, SEQ)).astype(np.int32)
                   for k in ("tokens", "labels")} for a in REDUCED}
    real = run_ranks(4, tmp, step_job, REDUCED, batches)
    cells = {a: _cell(a) for a in REDUCED}
    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, out + err
    with open(tmp / "ref_out.pkl", "rb") as f:
        ref = pickle.load(f)
    return dict(tmp=tmp, real=real, cells=cells, ref=ref, dryrun=dryrun)


# ----------------------------------------------------------------------
# the sweep's cells and skip records
# ----------------------------------------------------------------------
def test_the_sweep_has_the_references_80_cells_in_its_order(runs):
    from repro_torch import configs

    cells = list(runs["dryrun"].cells("all", "all", "both"))
    assert cells == runs["ref"]["cells"] and len(cells) == 80
    runnable = {(a, s) for a, s, _ in cells
                if configs.shape_applicable(configs.get_config(a), configs.SHAPES[s])}
    assert len(runnable) == 32


def test_every_skip_record_is_the_references(runs):
    skips = runs["ref"]["skips"]
    assert len(skips) == 16  # long_500k for the 8 archs without sub-quadratic attention, 2 meshes
    for (arch, shape, mesh), want in skips.items():
        assert runs["dryrun"].run_cell(arch, shape, mesh, verbose=False) == want


def test_the_cli_writes_the_references_skip_record_and_resumes(runs, capsys):
    out = runs["tmp"] / "cli"
    argv = ["--arch", "minicpm-2b", "--shape", "long_500k", "--mesh", "single", "--out", str(out)]
    runs["dryrun"].main(argv)
    with open(out / "minicpm-2b__long_500k__single.json") as f:
        rec = json.load(f)
    assert rec == runs["ref"]["skips"][("minicpm-2b", "long_500k", "single")]
    assert rec["status"] == "skipped" and rec["reason"] == "long_500k needs sub-quadratic attention"
    runs["dryrun"].main(argv)  # a cell whose JSON exists is skipped
    assert "skip (exists)" in capsys.readouterr().out


def test_save_hlo_is_refused_and_a_failed_cell_fails_the_sweep(runs):
    with pytest.raises(SystemExit, match="no optimized HLO"):
        runs["dryrun"].main(["--save-hlo", "--out", str(runs["tmp"] / "hlo")])
    with pytest.raises(SystemExit, match="1 cells failed"):
        runs["dryrun"].main(["--arch", "no-such-arch", "--shape", "train_4k", "--mesh", "single",
                             "--out", str(runs["tmp"] / "bad")])
    with open(runs["tmp"] / "bad" / "no-such-arch__train_4k__single.json") as f:
        assert json.load(f)["status"] == "error"


# ----------------------------------------------------------------------
# reduced cells traced on a fake process group
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", REDUCED)
def test_collectives_equal_the_real_steps_on_four_gloo_ranks(runs, arch):
    rec, real = runs["cells"][arch], runs["real"][0][arch]
    assert rec["status"] == "ok" and rec["micro_steps_traced"] == 1 and rec["n_micro"] == 2
    assert rec["collective_counts"] == real["counts"]
    assert rec["collective_bytes"] == real["sent"]
    assert rec["collective_input_bytes"] == real["input_bytes"]
    for other in runs["real"][1:]:  # every rank runs the same collectives
        assert other[arch] == runs["real"][0][arch]


@pytest.mark.parametrize("arch", REDUCED)
def test_argument_bytes_equal_the_references_memory_analysis(runs, arch):
    want = runs["ref"]["cost"][arch]["argument_size_in_bytes"]
    assert runs["cells"][arch]["memory"]["argument_size_in_bytes"] == want
    assert runs["cells"][arch]["memory"]["peak_live_bytes"] > want


@pytest.mark.parametrize("arch", REDUCED)
def test_flops_are_within_5_percent_of_the_references_walker(runs, arch):
    got, want = runs["cells"][arch]["cost"]["flops"], runs["ref"]["cost"][arch]["flops"]
    assert abs(got / want - 1) <= FLOPS_RTOL, (got, want, got / want)


def test_the_micro_step_is_what_the_design_predicts(runs):
    """The dense cell's micro-step (forward, backward, gradients placed)
    against ``comm.design_collectives`` from the spec tables."""
    from repro_torch.distributed import comm

    want = comm.design_collectives(_cfg("minicpm-2b"), {"data": 2, "model": 2}, GB // 2, SEQ)
    micro = runs["cells"]["minicpm-2b"]["micro_step"]
    assert micro["collective_counts"] == want["counts"]
    assert micro["collective_bytes"] == want["sent"]


@pytest.mark.parametrize("arch,layers,full", [("minicpm-2b", (1, 2), 4),
                                               ("zamba2-2.7b", (2, 4), 8)])
def test_two_depths_extrapolate_to_the_full_trace(arch, layers, full):
    """``run_cell(..., layers=)``: traces at two depths extrapolated to the
    stack's depth give the full trace's record (train and decode)."""
    cfg = dataclasses.replace(_cfg(arch), num_layers=full)
    md = ((2, 2), ("data", "model"))
    from repro_torch.launch import dryrun

    for kind in ("train", "decode"):
        shape = dataclasses.replace(_shape(), kind=kind)
        whole = dryrun.run_cell(arch, "train_4k", "single", verbose=False, cfg=cfg, shape=shape,
                                mesh_dims=md)
        ext = dryrun.run_cell(arch, "train_4k", "single", verbose=False, cfg=cfg, shape=shape,
                              mesh_dims=md, layers=layers)
        assert ext["layers_traced"] == list(layers)
        for key in ("memory", "cost", "collective_counts", "collective_bytes",
                    "collective_input_bytes", "micro_step"):
            assert ext.get(key) == whole.get(key), (kind, key)


@pytest.mark.parametrize("mesh_kind,n", [("single", 256), ("multi", 512)])
def test_a_reduced_cell_on_the_production_meshes(mesh_kind, n):
    """The fake 16x16 and 2x16x16 meshes, rank 0 of 256 and 512."""
    dims = ((2, 16, 16), ("pod", "data", "model")) if mesh_kind == "multi" else \
        ((16, 16), ("data", "model"))
    rec = _cell("minicpm-2b", dims, _shape(b=64), mesh_kind)
    assert rec["status"] == "ok" and rec["n_devices"] == n
    assert rec["n_micro"] == (2 if mesh_kind == "single" else 1)
    assert rec["cost"]["flops"] > 0 and rec["collective_counts"]["all_gather"] > 0


def test_bundle_lower_returns_the_record_run_cell_writes(runs):
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry

    cfg = _cfg("minicpm-2b")
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        bundle = steps.build_train_step(registry.Model(cfg, {}, train=True), mesh, _shape())
        rec = bundle.lower()
    want = runs["cells"]["minicpm-2b"]
    for key in ("memory", "cost", "collective_counts", "collective_bytes", "micro_step"):
        assert rec[key] == want[key], key
