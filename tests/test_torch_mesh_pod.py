"""The port on a (pod, data, model) mesh of 8 gloo ranks (2x2x2) against
the JAX package: the train step, its shards and one micro-step's
collectives, checkpoints from 2x2x2 to 2x2 and 1x1 in both packages, and
DeepSeek's prefill and decode bundles.

The batch is split over the tuple ``("pod", "data")`` and FSDP over
``data`` alone, so a gradient is reduce-scattered over ``data`` and its
shard all-reduced over ``pod`` (``comm.design_collectives``' pod term).
The reference runs in this process on a 1x1 mesh and in one subprocess
with eight host devices on 2x2x2 (then restoring the port's 2x2x2
checkpoint on a 2x2 mesh of four of them).

Tolerances, each with its reason:

* the train step at float32 (reduced MiniCPM, one step of one
  micro-step on 2x2x2, 4 on 1x1): metrics within 1e-5 relative, every
  parameter and both moments within 1e-4 of the leaf's largest entry --
  float32 roundings summed in another order across shards;
* serving at float32 with float32 caches: logits within ``F32`` (rtol
  1e-4, atol 2e-4) of one rank, caches within ``CACHE`` (one bf16 ulp
  of rounding order, atol 1e-6);
* checkpoints and shard shapes: exact.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import _torch_mesh_families as fam
from _torch_ranks import run_ranks

F32, CACHE = fam.F32, fam.CACHE
SEQ, GB = fam.SEQ, fam.GB
POD = (2, 2, 2)
AXES = ("pod", "data", "model")


def _mesh(shape=POD, axes=AXES):
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, "cpu")


# ----------------------------------------------------------------------
# rank jobs: repro_torch and numpy only
# ----------------------------------------------------------------------
def pod_job(_, np_params, batch, ckpt_dir, ds_params, prompts):
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import comm
    from repro_torch.distributed.sharding import activation_rules, batch_shardings, place
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.models.common import iter_leaves
    from repro_torch.train.optimizer import adamw_init

    mesh = _mesh()
    cfg = fam.tcfg("minicpm-2b")
    model = fam.model_on(mesh, cfg, np_params)
    bundle = steps.build_train_step(model, mesh, fam.shape(), **fam.TRAIN_KW)
    params = model.params()
    opt = adamw_init(params, bundle.opt_cfg)
    params, opt, m = bundle(params, opt, batch)
    out = {"rank": dist.get_rank(), "n_micro": bundle.n_micro,
           "metrics": {k: float(v) for k, v in m.items()},
           "shards": {n: tuple(p.to_local().shape) for n, p in iter_leaves(params)},
           "placements": {n: tuple(p.placements) for n, p in iter_leaves(params)},
           "state": {"params": fam.full(params), "mu": fam.full(opt.mu), "nu": fam.full(opt.nu)}}
    CheckpointManager(ckpt_dir).save(1, {"params": params, "opt": opt._asdict()})

    # one micro-step's collectives against the design
    mb = fam.shape(b=GB // bundle.n_micro)
    with comm.CollectiveLog() as log, steps.sharded(activation_rules(mesh)):
        loss, _ = registry.loss(cfg, params, place(
            {k: v[:mb.global_batch] for k, v in batch.items()},
            batch_shardings(model.batch_spec(mb), mesh), mesh))
        loss.backward()
        for p in model.parameters():
            steps._as_placed(p.grad, p)
    for p in model.parameters():
        p.grad = None
    out["comm"] = {"counts": dict(log.counts), "sent": dict(log.sent),
                   "design": comm.design_collectives(cfg, dict(zip(AXES, POD)), mb.global_batch,
                                                     SEQ)}

    # DeepSeek (MoE, MLA, expert-TP) prefill and 3 decode steps, batch over (pod, data)
    dcfg = fam.tcfg("deepseek-v2-lite-16b")
    dmodel = fam.model_on(mesh, dcfg, ds_params, train=False)
    b, t = prompts.shape
    length = t + fam.EXTRA
    pre = steps.build_prefill_step(dmodel, mesh, fam.shape("prefill", length, b))
    dec = steps.build_decode_step(dmodel, mesh, fam.shape("decode", length, b))
    logits, caches = fam.serve(lambda x, c: pre(dmodel.params(), x, c),
                               lambda tok, c, pos: dec(dmodel.params(), c, tok, pos),
                               {"tokens": prompts}, fam.f32(dmodel.init_cache(b, length)),
                               fam.GEN, t)
    out.update(ds=logits, ds_caches=fam.full(caches),
               token_placements=tuple(pre.in_shardings[1]["tokens"]))
    return out


def restore_job(_, np_params, ckpt_dir):
    """The 2x2x2 checkpoint restored on a 2x2 mesh of 4 ranks."""
    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import steps
    from repro_torch.train.optimizer import adamw_init

    mesh = _mesh((2, 2), ("data", "model"))
    model = fam.model_on(mesh, fam.tcfg("minicpm-2b"), np_params)
    p = model.params()
    step, o = steps.restore_train_state(CheckpointManager(ckpt_dir), p,
                                        adamw_init(p, steps.AdamWConfig(lr=None)))
    state = {"params": fam.full(p), "mu": fam.full(o.mu), "nu": fam.full(o.nu)}
    return (step, int(o.step), state) if dist.get_rank() == 0 else None


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------
REF_POD = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.checkpoint.manager import CheckpointManager
from repro.configs import SHAPES, get_config, reduced
from repro.launch.mesh import make_mesh
from repro.launch import steps
from repro.models import build_model
from repro.train.optimizer import AdamWConfig, adamw_init

inp = pickle.load(open(sys.argv[1], "rb"))
cfg = dataclasses.replace(reduced(get_config("minicpm-2b")), compute_dtype="float32")
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=inp["seq"], global_batch=inp["gb"])
mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
order = {d.id: i for i, d in enumerate(mesh.devices.flat)}
bundle = steps.build_train_step(build_model(cfg), mesh, shape, **inp["kw"])
params = jax.tree.map(jnp.asarray, inp["params"])
opt = adamw_init(params, AdamWConfig(lr=None))
with mesh:
    params = jax.device_put(params, bundle.in_shardings[0])
    opt = jax.device_put(opt, bundle.in_shardings[1])
    params, opt, m = bundle.jit()(params, opt, inp["batch"])
shards = {}
def walk(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            walk(v, prefix + k + ".")
        else:
            shards[prefix + k] = {order[s.device.id]: tuple(s.data.shape)
                                  for s in v.addressable_shards}
walk(params)
# the port's 2x2x2 checkpoint restored on a 2x2 mesh of four devices
mesh22 = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
b22 = steps.build_train_step(build_model(cfg), mesh22, shape, **inp["kw"])
template = {"params": params, "opt": opt._asdict()}
step, state = CheckpointManager(inp["ckpt"]).restore(
    template, shardings={"params": b22.in_shardings[0], "opt": b22.in_shardings[1]._asdict()})
layouts = sorted({str(x.sharding.spec) for x in jax.tree.leaves(state["params"])})
pickle.dump({"metrics": {k: float(v) for k, v in m.items()},
             "params": jax.tree.map(np.asarray, params), "mu": jax.tree.map(np.asarray, opt.mu),
             "nu": jax.tree.map(np.asarray, opt.nu), "shards": shards,
             "restored": (step, jax.tree.map(np.asarray, state["params"]),
                          jax.tree.map(np.asarray, state["opt"]["mu"]),
                          jax.tree.map(np.asarray, state["opt"]["nu"])),
             "restored_layouts": layouts}, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import dataclasses

    import jax

    from _subproc import subprocess_env
    from repro.configs import SHAPES, get_config, reduced
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch import steps as rsteps
    from repro.models import build_model as rbuild
    from repro.train.optimizer import AdamWConfig, adamw_init

    tmp = tmp_path_factory.mktemp("pod")
    for sub in ("pod", "restore"):
        (tmp / sub).mkdir()
    rcfg = dataclasses.replace(reduced(get_config("minicpm-2b")), compute_dtype="float32")
    params = rbuild(rcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    batch = SyntheticLM(DataConfig(rcfg.vocab_size, SEQ, GB)).batch(0)
    dcfg = dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")), compute_dtype="float32")
    ds_params = jax.tree.map(np.asarray, rbuild(dcfg).init(jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(1).integers(0, dcfg.vocab_size, (4, 8)).astype(np.int32)
    ckpt = str(tmp / "ck222")

    pod = run_ranks(8, tmp / "pod", pod_job, np_params, batch, ckpt, ds_params, prompts)
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump({"params": np_params, "batch": batch, "seq": SEQ, "gb": GB,
                     "kw": fam.TRAIN_KW, "ckpt": ckpt}, f)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_POD), str(tmp / "ref_in.pkl"),
         str(tmp / "ref_out.pkl")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=subprocess_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"), cwd=".")
    restored22 = run_ranks(4, tmp / "restore", restore_job, np_params, ckpt)[0]

    # the reference and the port on 1x1
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    bundle = rsteps.build_train_step(rbuild(rcfg), mesh, dataclasses.replace(
        SHAPES["train_4k"], seq_len=SEQ, global_batch=GB), **fam.TRAIN_KW)
    with mesh:
        rp, ro, m = bundle.jit()(params, adamw_init(params, AdamWConfig(lr=None)), batch)
    ref11 = {"metrics": {k: float(v) for k, v in m.items()},
             "params": jax.tree.map(np.asarray, rp), "mu": jax.tree.map(np.asarray, ro.mu),
             "nu": jax.tree.map(np.asarray, ro.nu)}
    model = fam.model_on(None, fam.tcfg("deepseek-v2-lite-16b"), ds_params, train=False)
    length = prompts.shape[1] + fam.EXTRA
    ds, ds_caches = fam.serve(model.prefill, model.decode_step, {"tokens": prompts},
                              fam.f32(model.init_cache(4, length)), fam.GEN, prompts.shape[1])

    out, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, out + err
    with open(tmp / "ref_out.pkl", "rb") as f:
        ref222 = pickle.load(f)
    return dict(pod=pod, ref11=ref11, ref222=ref222, restored22=restored22, ckpt=ckpt,
                np_params=np_params, one={"ds": ds, "ds_caches": fam.full(ds_caches)})


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ref", ["1x1", "2x2x2"])
def test_train_step_on_2x2x2_matches_the_reference(runs, ref):
    want = runs["ref11"] if ref == "1x1" else runs["ref222"]
    got = runs["pod"][0]
    for k in ("loss", "xent", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    for key in ("params", "mu", "nu"):
        fam.within(got["state"][key], want[key], 1e-4)


def test_the_batch_is_split_over_pod_and_data_and_fsdp_over_data_alone(runs):
    from torch.distributed.tensor import Replicate, Shard

    got = runs["pod"][0]
    assert got["n_micro"] == 1  # 8 rows over pod x data = 4, 2 a micro-step
    assert got["token_placements"] == (Shard(0), Shard(0), Replicate())
    # [L, d, h hd]: the layers' FSDP dim over data, whole over pod
    assert got["placements"]["layers.attn.wq"] == (Replicate(), Shard(1), Shard(2))


def test_local_shards_are_the_references_addressable_shards(runs):
    ref = runs["ref222"]["shards"]
    for out in runs["pod"]:
        assert sorted(out["shards"]) == sorted(ref)
        for name, s in out["shards"].items():
            assert s == ref[name][out["rank"]], (name, out["rank"], s)


def test_one_micro_step_moves_what_the_design_predicts_with_its_pod_term(runs):
    """Reduced MiniCPM on 2x2x2: the (data, model) design's 38 all-gathers
    and 38 reduce-scatters over ``data``, and 66 all-reduces: the 26 of
    the (data, model) design at a quarter of the rows a rank, each
    gradient shard's all-reduce over ``pod`` (38), and the loss and
    ``final_norm``'s gradient over ``pod`` too (2)."""
    for out in runs["pod"]:
        comm = out["comm"]
        assert comm["counts"] == {"all_gather": 38, "all_reduce": 66, "reduce_scatter": 38}
        assert comm["counts"] == comm["design"]["counts"], comm
        assert comm["sent"] == comm["design"]["sent"], comm


# ----------------------------------------------------------------------
# checkpoints: 2x2x2 -> 2x2 and 1x1, in both packages
# ----------------------------------------------------------------------
def _saved(runs, key):
    return fam.leaves(runs["pod"][0]["state"][key])


def test_a_2x2x2_checkpoint_restores_on_2x2_in_both_packages(runs):
    step, opt_step, state = runs["restored22"]
    assert step == opt_step == 1
    for key in ("params", "mu", "nu"):
        for name, x in fam.leaves(state[key]).items():
            np.testing.assert_array_equal(x, _saved(runs, key)[name], err_msg=name)
    rstep, rp, rmu, rnu = runs["ref222"]["restored"]
    assert rstep == 1
    assert "PartitionSpec(None, 'data', 'model')" in runs["ref222"]["restored_layouts"]
    for key, tree in (("params", rp), ("mu", rmu), ("nu", rnu)):
        for name, x in fam.leaves(tree).items():
            np.testing.assert_array_equal(x, _saved(runs, key)[name], err_msg=name)


def test_a_2x2x2_checkpoint_restores_on_1x1_in_both_packages(runs):
    import jax

    from repro.checkpoint.manager import CheckpointManager as RMgr
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import steps
    from repro_torch.train.optimizer import adamw_init as tadamw_init

    model = fam.model_on(None, fam.tcfg("minicpm-2b"), runs["np_params"])
    p = model.params()
    step, opt = steps.restore_train_state(CheckpointManager(runs["ckpt"]), p,
                                          tadamw_init(p, steps.AdamWConfig(lr=None)))
    assert step == int(opt.step) == 1
    for key, tree in (("params", p), ("mu", opt.mu), ("nu", opt.nu)):
        for name, x in fam.leaves(fam.full(tree)).items():
            np.testing.assert_array_equal(x, _saved(runs, key)[name], err_msg=name)
    params = jax.tree.map(jax.numpy.asarray, runs["np_params"])
    template = {"params": params, "opt": adamw_init(params, AdamWConfig(lr=None))._asdict()}
    rstep, state = RMgr(runs["ckpt"]).restore(template)
    assert rstep == 1
    for key, tree in (("params", state["params"]), ("mu", state["opt"]["mu"]),
                      ("nu", state["opt"]["nu"])):
        for name, x in fam.leaves(jax.tree.map(np.asarray, tree)).items():
            np.testing.assert_array_equal(x, _saved(runs, key)[name], err_msg=name)


# ----------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------
def test_moe_prefill_and_decode_bundles_on_2x2x2_match_one_rank(runs):
    for out in runs["pod"]:
        fam.close_logits(out["ds"], runs["one"]["ds"])
    fam.close_caches(runs["pod"][0]["ds_caches"], runs["one"]["ds_caches"], CACHE)


def test_the_checkpoint_directory_holds_one_whole_copy(runs):
    """Rank 0 writes the whole state once (the reference's layout), not
    a shard a rank."""
    steps_dir = [d for d in os.listdir(runs["ckpt"]) if d.startswith("step_")]
    assert steps_dir == ["step_0000000001"]
    with np.load(os.path.join(runs["ckpt"], steps_dir[0], "arrays.npz")) as npz:
        assert npz["params/layers/attn/wq"].shape == runs["np_params"]["layers"]["attn"]["wq"].shape
