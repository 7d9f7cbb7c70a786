"""The port on a (data, model) mesh of gloo ranks against the JAX
package: the sharded train step, its shards, checkpoints across meshes,
the sharded prefill and decode bundles, ``pipeline_forward``, the
collectives of a micro-step and the mesh launchers.

Four ranks are spawned (``tests/_torch_ranks.py``: ``torch.set_num_threads(1)``
each, a ``FileStore`` under ``tmp_path``, a join limit), each importing
only ``repro_torch`` and numpy; the reference runs in this process on a
1x1 mesh and in one subprocess with four host devices on 2x2 and on a
four-stage pipeline.  Everything either side compares comes from the same
numpy inputs.

Tolerances, each with its reason:

* the train step at float32 (reduced MiniCPM, 2 steps, 2 micro-steps):
  metrics within 1e-5 relative, every parameter and both moments within
  1e-4 of the leaf's largest entry -- float32 roundings summed in
  another order across shards (observed: under 1e-6);
* bfloat16 compute: each leaf's gradient as accurate as the reference's
  (C13): its Frobenius distance from the reference's float32 gradient at
  most twice the reference bfloat16 gradient's own;
* serving at float32 with float32 caches (no bfloat16 rounding boundary
  inside the comparison): logits within ``F32`` (rtol 1e-4, atol 2e-4)
  of the one-rank run, caches within ``CACHE``;
* ``pipeline_forward``: 1e-6 relative of the reference's;
* checkpoints and shard shapes: exact.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks

F32 = dict(rtol=1e-4, atol=2e-4)
CACHE = dict(rtol=2.0**-7, atol=1e-6)
SEQ, GB, MBS, STEPS = 16, 8, 2, 2
TRAIN_KW = dict(lr=3e-3, schedule="cosine", total_steps=20, microbatch_seqs=MBS)


def _tcfg(arch, dtype="float32"):
    from repro_torch import configs

    return dataclasses.replace(configs.reduced(configs.get_config(arch)), compute_dtype=dtype)


def _shape(kind="train", seq=SEQ, b=GB):
    from repro_torch.configs import SHAPES

    return dataclasses.replace(SHAPES["train_4k"], kind=kind, seq_len=seq, global_batch=b)


def _mesh22():
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((2, 2), ("data", "model"), "cpu")


def _model_on(mesh, cfg, np_params, train=True):
    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    model = build_model(cfg, device="cpu", train=train)
    model.load_state_dict(convert.decoder_params_from_reference(cfg, np_params))
    if mesh is not None:
        steps.place_params(model, mesh)
    return model


def _full(tree):
    from repro_torch.models.common import map_tree

    return map_tree(lambda _, x: (x.full_tensor() if hasattr(x, "full_tensor") else x)
                    .detach().float().numpy(), tree)


# ----------------------------------------------------------------------
# rank jobs: repro_torch and numpy only
# ----------------------------------------------------------------------
def train_job(_, np_params, bf16_params, batches, ckpt_dir, ref_ckpt_dir):
    """The 2x2 train step (2 steps) at float32; each rank's local shard
    shapes; the collectives of one micro-step; a bfloat16 gradient; a
    checkpoint written on 2x2, and the 1x1 checkpoints restored here."""
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import comm, staged
    from repro_torch.distributed.sharding import activation_rules, batch_shardings, place
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.models.common import iter_leaves
    from repro_torch.train.optimizer import adamw_init

    mesh = _mesh22()
    cfg = _tcfg("minicpm-2b")
    model = _model_on(mesh, cfg, np_params)
    bundle = steps.build_train_step(model, mesh, _shape(), **TRAIN_KW)
    params = model.params()
    opt = adamw_init(params, bundle.opt_cfg)
    metrics = []
    for batch in batches:
        params, opt, m = bundle(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    shards = {n: tuple(p.to_local().shape) for n, p in iter_leaves(params)}
    state = {"params": _full(params), "mu": _full(opt.mu), "nu": _full(opt.nu)}

    mgr = CheckpointManager(ckpt_dir)
    mgr.save(STEPS, {"params": params, "opt": opt._asdict()})
    restored = {}
    for name in ("port", "ref"):
        fresh = _model_on(mesh, cfg, np_params)
        p0 = fresh.params()
        step, o = steps.restore_train_state(CheckpointManager(os.path.join(ref_ckpt_dir, name)),
                                            p0, adamw_init(p0, bundle.opt_cfg))
        assert all(x.placements == y.placements for (_, x), (_, y) in
                   zip(iter_leaves(p0), iter_leaves(params)))
        restored[name] = (step, _full(p0), _full(o.mu), _full(o.nu), int(o.step))

    # one micro-step's collectives (forward, backward, gradients onto
    # shards), counted by torch's CommDebugMode and by comm.CollectiveLog;
    # then the same micro-step with DTensor's collectives staged through
    # the host (as gloo ranks sharing a card run them)
    mb = _shape(b=GB // bundle.n_micro)
    b_sh = batch_shardings(model.batch_spec(mb), mesh)

    def micro_step():
        with steps.sharded(activation_rules(mesh)):
            loss, _ = registry.loss(cfg, params, place(
                {k: v[: mb.global_batch] for k, v in batches[0].items()}, b_sh, mesh))
            loss.backward()
            grads = {n: steps._as_placed(p.grad, p).to_local().clone()
                     for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        return float(loss.to_local()), grads

    counts, log = CommDebugMode(), comm.CollectiveLog()
    with counts, log:
        loss0, grads0 = micro_step()
    debug = {str(k).rsplit(".", 1)[-1]: v for k, v in counts.get_comm_counts().items()}
    staged_log = comm.CollectiveLog()
    with staged.host_collectives(), staged_log:
        loss1, grads1 = micro_step()
    comm_out = {"debug": debug, "counts": dict(log.counts), "sent": dict(log.sent),
                "design": comm.design_collectives(cfg, {"data": 2, "model": 2},
                                                  mb.global_batch, SEQ),
                "staged_counts": dict(staged_log.counts), "staged_sent": dict(staged_log.sent),
                "staged_equal": loss1 == loss0 and all(torch.equal(grads0[n], grads1[n])
                                                       for n in grads0)}

    # a bfloat16-compute gradient on the mesh
    bcfg = _tcfg("minicpm-2b", "bfloat16")
    bmodel = _model_on(mesh, bcfg, bf16_params)
    with steps.sharded(activation_rules(mesh)):
        loss, _ = registry.loss(bcfg, bmodel.params(), place(
            dict(batches[0]), batch_shardings(bmodel.batch_spec(_shape()), mesh), mesh))
        loss.backward()
        grads = {n: steps._as_placed(p.grad, p).full_tensor().float().numpy()
                 for n, p in bmodel.named_parameters()}
    out = {"shards": shards, "rank": dist.get_rank()}
    if dist.get_rank() == 0:
        out.update(metrics=metrics, state=state, restored=restored, comm=comm_out, bf16_grads=grads,
                   bf16_loss=float(loss.full_tensor()))
    else:
        loss.full_tensor()
    return out


def serve_job(_, ds_params, mi_params, prompts, mi_caches, mi_tok):
    """DeepSeek's (MoE, MLA, expert-TP) prefill and 3 decode steps on
    2x2, and Mistral's decode bundle at batch 1 on data = 2 (long
    context) from prefilled caches; float32 compute and caches."""
    import torch.distributed as dist

    from repro_torch.distributed import comm
    from repro_torch.launch import steps
    from repro_torch.models.common import map_tree

    mesh = _mesh22()
    f32 = lambda tree: map_tree(lambda _, a: a.float() if a.is_floating_point() else a, tree)  # noqa: E731
    cfg = _tcfg("deepseek-v2-lite-16b")
    model = _model_on(mesh, cfg, ds_params, train=False)
    b, t = prompts.shape
    length = t + 4
    pre = steps.build_prefill_step(model, mesh, _shape("prefill", length, b))
    dec = steps.build_decode_step(model, mesh, _shape("decode", length, b))
    logits, caches = pre(model.params(), {"tokens": prompts}, f32(model.init_cache(b, length)))
    ds = [logits.full_tensor().numpy()]
    tok = ds[0][:, -1].argmax(-1).astype(np.int32)[:, None]
    for i in range(3):
        logits, caches = dec(model.params(), caches, tok, np.full((b, 1), t + i, np.int32))
        ds.append(logits.full_tensor().numpy())
        tok = ds[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
    ds_caches = _full(caches)

    mcfg = _tcfg("mistral-nemo-12b")
    mmodel = _model_on(mesh, mcfg, mi_params, train=False)
    length = mi_caches["layers"]["k"].shape[2]
    dec = steps.build_decode_step(mmodel, mesh, _shape("decode", length, 1))
    caches = map_tree(lambda _, a: torch.as_tensor(a), mi_caches)
    pos = int(caches["layers"]["idx"][0])
    spec = dec.in_shardings[1]["layers"]["k"]
    mi, logs = [], []
    tok = mi_tok
    for i in range(3):
        with comm.CollectiveLog() as log:
            logits, caches = dec(mmodel.params(), caches, tok, np.full((1, 1), pos + i, np.int32))
        logs.append({"counts": dict(log.counts), "input_bytes": dict(log.input_bytes)})
        mi.append(logits.full_tensor().numpy())
        tok = mi[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
    # what a rank holds of the weights it gathers
    fsdp = sum(p.to_local().numel() * p.to_local().element_size()
               for p in mmodel.parameters() if p.placements[0].is_shard())
    if dist.get_rank() != 0:
        _full(caches)
        return None
    return {"ds": ds, "ds_caches": ds_caches, "mi": mi, "mi_caches": _full(caches),
            "long_spec": list(spec), "long_logs": logs, "long_fsdp": fsdp}


def pipeline_job(_, w, x):
    """``pipeline_forward`` over a 4-stage ``stage`` mesh; the mesh
    constructors over the 4 ranks."""
    import torch.distributed as dist

    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch.mesh import describe, make_elastic_mesh, make_mesh

    mesh = make_mesh((4,), ("stage",), "cpu")
    out = pipeline_forward(lambda p, h: torch.tanh(h @ p["w"]), {"w": torch.tensor(w)},
                           torch.tensor(x), mesh, axis="stage")
    meshes = [describe(make_elastic_mesh(device_type="cpu")),
              describe(make_elastic_mesh(2, device_type="cpu"))]
    try:
        make_mesh((2, 3), ("data", "model"), "cpu")
        meshes.append("no error")
    except ValueError as e:
        meshes.append(str(e))
    return out.numpy(), dist.get_rank(), meshes


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------
REF_2X2 = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import SHAPES, get_config, reduced
from repro.distributed.pipeline import pipeline_forward
from repro.launch.mesh import make_mesh
from repro.launch import steps
from repro.models import build_model
from repro.train.optimizer import AdamWConfig, adamw_init

inp = pickle.load(open(sys.argv[1], "rb"))
import dataclasses
cfg = dataclasses.replace(reduced(get_config("minicpm-2b")), compute_dtype="float32")
mesh = make_mesh((2, 2), ("data", "model"))
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=inp["seq"], global_batch=inp["gb"])
bundle = steps.build_train_step(build_model(cfg), mesh, shape, **inp["kw"])
params = jax.tree.map(jnp.asarray, inp["params"])
opt = adamw_init(params, AdamWConfig(lr=None))
metrics = []
with mesh:
    params = jax.device_put(params, bundle.in_shardings[0])
    opt = jax.device_put(opt, bundle.in_shardings[1])
    step = bundle.jit()
    for batch in inp["batches"]:
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
order = {d.id: i for i, d in enumerate(mesh.devices.flat)}
shards = {}
def walk(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            walk(v, prefix + k + ".")
        else:
            shards[prefix + k] = {order[s.device.id]: tuple(s.data.shape) for s in v.addressable_shards}
walk(params)
pmesh = make_mesh((4,), ("stage",))
pipe = pipeline_forward(lambda p, h: jnp.tanh(h @ p["w"]), {"w": jnp.asarray(inp["w"])},
                        jnp.asarray(inp["x"]), pmesh, axis="stage")
pickle.dump({"metrics": metrics, "params": jax.tree.map(np.asarray, params),
             "mu": jax.tree.map(np.asarray, opt.mu), "nu": jax.tree.map(np.asarray, opt.nu),
             "shards": shards, "pipe": np.asarray(pipe)}, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every rank job and both reference runs, once for the module."""
    import pickle

    import jax

    from _subproc import subprocess_env
    from repro.checkpoint.manager import CheckpointManager as RMgr
    from repro.configs import SHAPES, get_config, reduced
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.launch import steps as rsteps
    from repro.models import build_model as rbuild
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import steps
    from repro_torch.train.optimizer import adamw_init as tadamw_init

    tmp = tmp_path_factory.mktemp("mesh")
    for sub in ("train", "serve", "pipe"):
        (tmp / sub).mkdir()
    rcfg = dataclasses.replace(reduced(get_config("minicpm-2b")), compute_dtype="float32")
    params = rbuild(rcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    data = SyntheticLM(DataConfig(rcfg.vocab_size, SEQ, GB))
    batches = [data.batch(i) for i in range(STEPS)]
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(4, 8, 8)) * 0.3).astype(np.float32)
    x = rng.normal(size=(6, 2, 8)).astype(np.float32)
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump({"params": np_params, "batches": batches, "seq": SEQ, "gb": GB,
                     "kw": TRAIN_KW, "w": w, "x": x}, f)
    ref22 = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_2X2), str(tmp / "ref_in.pkl"),
         str(tmp / "ref_out.pkl")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=subprocess_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"), cwd=".")

    # the reference on 1x1, and a 1x1 checkpoint from each package
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    bundle = rsteps.build_train_step(rbuild(rcfg), mesh, dataclasses.replace(
        SHAPES["train_4k"], seq_len=SEQ, global_batch=GB), **TRAIN_KW)
    rp, ro, ref_metrics = params, adamw_init(params, AdamWConfig(lr=None)), []
    with mesh:
        step = bundle.jit()
        for batch in batches:
            rp, ro, m = step(rp, ro, batch)
            ref_metrics.append({k: float(v) for k, v in m.items()})
    ref11 = {"params": jax.tree.map(np.asarray, rp), "mu": jax.tree.map(np.asarray, ro.mu),
             "nu": jax.tree.map(np.asarray, ro.nu), "metrics": ref_metrics}
    RMgr(str(tmp / "ck11" / "ref")).save(STEPS, {"params": rp, "opt": ro._asdict()})
    tmodel = _model_on(None, _tcfg("minicpm-2b"), np_params)
    tstep = steps.build_train_step(tmodel, None, _shape(), **TRAIN_KW)
    tp = tmodel.params()
    to = tadamw_init(tp, tstep.opt_cfg)
    for batch in batches:
        tp, to, _ = tstep(tp, to, batch)
    CheckpointManager(str(tmp / "ck11" / "port")).save(STEPS, {"params": tp, "opt": to._asdict()})
    port11 = {"params": _full(tp), "mu": _full(to.mu), "nu": _full(to.nu)}

    bcfg = reduced(get_config("minicpm-2b"))  # bfloat16 compute
    bf16_params = jax.tree.map(np.asarray, rbuild(bcfg).init(jax.random.PRNGKey(0)))

    train = run_ranks(4, tmp / "train", train_job, np_params, bf16_params, batches,
                      str(tmp / "ck22"), str(tmp / "ck11"))

    # serving: DeepSeek prefill + decode on 2x2 against one rank; Mistral
    # long-context decode from caches prefilled on one rank
    from repro_torch.models.common import map_tree

    f32 = lambda tree: map_tree(lambda _, a: a.float() if a.is_floating_point() else a, tree)  # noqa: E731
    dcfg = dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")), compute_dtype="float32")
    ds_params = jax.tree.map(np.asarray, rbuild(dcfg).init(jax.random.PRNGKey(0)))
    mcfg = dataclasses.replace(reduced(get_config("mistral-nemo-12b")), compute_dtype="float32")
    mi_params = jax.tree.map(np.asarray, rbuild(mcfg).init(jax.random.PRNGKey(0)))
    prompts = np.random.default_rng(1).integers(0, dcfg.vocab_size, (2, 8)).astype(np.int32)
    one = {}
    ds = _model_on(None, _tcfg("deepseek-v2-lite-16b"), ds_params, train=False)
    logits, caches = ds.prefill({"tokens": prompts}, f32(ds.init_cache(2, 12)))
    one["ds"] = [logits.numpy()]
    tok = logits[:, -1].argmax(-1).int().numpy()[:, None]
    for i in range(3):
        logits, caches = ds.decode_step(tok, caches, np.full((2, 1), 8 + i, np.int32))
        one["ds"].append(logits.numpy())
        tok = logits[:, -1].argmax(-1).int().numpy()[:, None]
    one["ds_caches"] = _full(caches)
    mi = _model_on(None, _tcfg("mistral-nemo-12b"), mi_params, train=False)
    logits, caches = mi.prefill({"tokens": prompts[:1]}, f32(mi.init_cache(1, 12)))
    mi_caches = map_tree(lambda _, a: a.numpy(), caches)
    mi_tok = logits[:, -1].argmax(-1).int().numpy()[:, None]
    one["mi"] = []
    tok = mi_tok
    for i in range(3):
        logits, caches = mi.decode_step(tok, caches, np.full((1, 1), 8 + i, np.int32))
        one["mi"].append(logits.numpy())
        tok = logits[:, -1].argmax(-1).int().numpy()[:, None]
    one["mi_caches"] = _full(caches)
    serve = run_ranks(4, tmp / "serve", serve_job, ds_params, mi_params, prompts, mi_caches, mi_tok)
    pipe = run_ranks(4, tmp / "pipe", pipeline_job, w, x)

    out, err = ref22.communicate(timeout=300)
    assert ref22.returncode == 0, out + err
    with open(tmp / "ref_out.pkl", "rb") as f:
        ref22 = pickle.load(f)
    return dict(tmp=tmp, np_params=np_params, bf16_params=bf16_params, batches=batches,
                ref11=ref11, ref22=ref22, port11=port11, train=train, serve=serve[0], one=one,
                pipe=pipe, w=w, x=x)


def _leaves(tree):
    from repro_torch.models.common import iter_leaves

    return dict(iter_leaves(tree))


def _within(port, ref, rel):
    for name, r in _leaves(ref).items():
        p = _leaves(port)[name]
        np.testing.assert_allclose(p, r, rtol=0, atol=rel * np.abs(r).max() + 1e-12, err_msg=name)


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ref", ["1x1", "2x2"])
def test_train_step_on_2x2_matches_the_reference(runs, ref):
    want = runs["ref11"] if ref == "1x1" else runs["ref22"]
    got = runs["train"][0]
    for r, p in zip(want["metrics"], got["metrics"]):
        for k in ("loss", "xent", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(p[k], r[k], rtol=1e-5, atol=1e-12, err_msg=k)
    for key in ("params", "mu", "nu"):
        _within(got["state"][key], want[key], 1e-4)


def test_one_device_step_matches_the_reference_too(runs):
    for key in ("params", "mu", "nu"):
        _within(runs["port11"][key], runs["ref11"][key], 1e-4)


def test_local_shards_are_the_references_addressable_shards(runs):
    ref = runs["ref22"]["shards"]
    for out in runs["train"]:
        rank = out["rank"]
        assert sorted(out["shards"]) == sorted(ref)
        for name, shape in out["shards"].items():
            assert shape == ref[name][rank], (name, rank, shape, ref[name][rank])


def test_bfloat16_gradients_on_2x2_are_as_accurate_as_the_reference(runs):
    """C13: each leaf's distance from the reference's float32 gradient at
    most twice the reference bfloat16 gradient's own."""
    import jax

    from repro.configs import get_config, reduced
    from repro.models import build_model as rbuild

    batch = {k: np.asarray(v) for k, v in runs["batches"][0].items()}
    ref = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(reduced(get_config("minicpm-2b")), compute_dtype=dtype)
        model = rbuild(cfg)
        params = jax.tree.map(jax.numpy.asarray, runs["bf16_params"])
        (_, _), g = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params, batch)
        ref[dtype] = _leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), g))
    got = runs["train"][0]["bf16_grads"]
    assert sorted(got) == sorted(ref["float32"])
    for name, g32 in ref["float32"].items():
        own = np.linalg.norm(ref["bfloat16"][name] - g32)
        assert np.linalg.norm(got[name] - g32) <= 2 * own + 1e-12, name


# ----------------------------------------------------------------------
# checkpoints across meshes, in both packages
# ----------------------------------------------------------------------
def test_a_2x2_checkpoint_restores_on_1x1_in_both_packages(runs):
    import jax

    from repro.checkpoint.manager import CheckpointManager as RMgr
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import steps
    from repro_torch.train.optimizer import adamw_init as tadamw_init

    path = str(runs["tmp"] / "ck22")
    saved = runs["train"][0]["state"]
    model = _model_on(None, _tcfg("minicpm-2b"), runs["np_params"])
    p = model.params()
    step, opt = steps.restore_train_state(CheckpointManager(path), p,
                                          tadamw_init(p, steps.AdamWConfig(lr=None)))
    assert step == STEPS and int(opt.step) == STEPS
    for key, tree in (("params", p), ("mu", opt.mu), ("nu", opt.nu)):
        for name, x in _leaves(_full(tree)).items():
            np.testing.assert_array_equal(x, _leaves(saved[key])[name], err_msg=name)
    params = jax.tree.map(jax.numpy.asarray, runs["np_params"])
    template = {"params": params, "opt": adamw_init(params, AdamWConfig(lr=None))._asdict()}
    rstep, state = RMgr(path).restore(template)
    assert rstep == STEPS
    for key, tree in (("params", state["params"]), ("mu", state["opt"]["mu"]),
                      ("nu", state["opt"]["nu"])):
        for name, x in _leaves(jax.tree.map(np.asarray, tree)).items():
            np.testing.assert_array_equal(x, _leaves(saved[key])[name], err_msg=name)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_1x1_checkpoint_restores_on_2x2(runs, writer):
    step, params, mu, nu, opt_step = runs["train"][0]["restored"][writer]
    assert step == opt_step == STEPS
    want = runs["port11"] if writer == "port" else runs["ref11"]
    for key, got in (("params", params), ("mu", mu), ("nu", nu)):
        for name, x in _leaves(want[key]).items():
            np.testing.assert_array_equal(_leaves(got)[name], np.asarray(x, np.float32),
                                          err_msg=name)


# ----------------------------------------------------------------------
# the collectives of one micro-step
# ----------------------------------------------------------------------
def test_one_micro_step_moves_what_the_design_predicts(runs):
    """Reduced MiniCPM (4 layers, tied embedding, every matrix divisible)
    on 2x2, forward + backward + gradients onto their shards:

    * all-gather (FSDP, over data): per layer its 7 matrices and 2 norm
      vectors, and the embedding twice (lookup and tied head): 4*9 + 2;
    * all-reduce: per layer the attention and MLP outputs (forward, over
      model) and their inputs' gradients (backward, over model); the
      embedding lookup (over model); the loss's max, sum of exponentials
      and label logit, each in the loss's forward and in its
      recomputation (over model); the loss over data; the xent input's
      gradient (over model); ``final_norm``'s gradient (replicated, over
      data): 4*4 + 1 + 6 + 1 + 1 + 1;
    * reduce-scatter (over data): every gradient back to its FSDP shard:
      per layer 9, and the embedding's two uses: 4*9 + 2.

    No weight is gathered over ``model``: TP splits the work.  torch's
    ``CommDebugMode`` and ``comm.CollectiveLog`` count the same, and the
    log's counts and the bytes a rank sends of every kind equal
    ``comm.design_collectives``, which derives them from the spec
    tables alone (the embedding's gradient reduce-scattered from the
    rank's vocab rows, not from the whole table)."""
    comm = runs["train"][0]["comm"]
    assert comm["debug"] == {"all_gather_into_tensor": 38, "all_reduce": 26,
                             "reduce_scatter_tensor": 38}, comm["debug"]
    assert comm["counts"] == {"all_gather": 38, "all_reduce": 26, "reduce_scatter": 38}
    assert comm["counts"] == comm["design"]["counts"], comm
    assert comm["sent"] == comm["design"]["sent"], comm


def test_host_staged_collectives_give_the_same_micro_step(runs):
    """``staged.host_collectives()`` (gloo ranks sharing a card stage
    DTensor's collectives through the host): the same micro-step gives
    the same loss and gradients bit for bit, and ``CollectiveLog`` counts
    the same collectives and bytes through the c10d calls it makes."""
    comm = runs["train"][0]["comm"]
    assert comm["staged_equal"]
    assert comm["staged_counts"] == comm["counts"]
    assert comm["staged_sent"] == comm["sent"]


# ----------------------------------------------------------------------
# serving bundles
# ----------------------------------------------------------------------
def test_moe_prefill_and_decode_bundles_on_2x2_match_one_rank(runs):
    got, want = runs["serve"], runs["one"]
    for g, w in zip(got["ds"], want["ds"]):
        np.testing.assert_allclose(g, w, **F32)
    for name, w in _leaves(want["ds_caches"]).items():
        np.testing.assert_allclose(_leaves(got["ds_caches"])[name], w, **CACHE, err_msg=name)


def test_long_context_decode_bundle_matches_one_rank(runs):
    got, want = runs["serve"], runs["one"]
    from torch.distributed.tensor import Shard

    assert got["long_spec"][0] == Shard(2)  # [L, B, S, KV, hd]: the seq over data
    for g, w in zip(got["mi"], want["mi"]):
        np.testing.assert_allclose(g, w, **F32)
    for name, w in _leaves(want["mi_caches"]).items():
        np.testing.assert_allclose(_leaves(got["mi_caches"])[name], w, **CACHE, err_msg=name)


def test_long_context_decode_gathers_weights_but_never_the_cache(runs):
    """Each long-context decode step all-gathers exactly the FSDP shards
    of the weights a rank holds (once each), so no rank gathers the
    sequence-sharded KV cache (the attention's partial softmaxes meet in
    all-reduces instead)."""
    got = runs["serve"]
    for log in got["long_logs"]:
        assert log["input_bytes"]["all_gather"] == got["long_fsdp"], log


# ----------------------------------------------------------------------
# pipeline parallelism
# ----------------------------------------------------------------------
def test_pipeline_forward_matches_the_reference_on_every_rank(runs):
    ref = runs["ref22"]["pipe"]
    want = runs["x"]
    for s in range(4):
        want = np.tanh(want @ runs["w"][s])
    np.testing.assert_allclose(ref, want, rtol=1e-5, atol=1e-6)
    assert sorted(r for _, r, _ in runs["pipe"]) == [0, 1, 2, 3]
    for out, _, _ in runs["pipe"]:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)


def test_mesh_constructors_on_four_ranks(runs):
    """``make_elastic_mesh``'s rule (model = min(16, n), halved until it
    divides n) over 4 ranks, ``describe``'s string, and a shape the world
    size does not fill raising as ``jax.make_mesh`` raises."""
    for _, _, meshes in runs["pipe"]:
        assert meshes[0] == "mesh{'data': 1, 'model': 4} over 4 devices"
        assert meshes[1] == "mesh{'data': 2, 'model': 2} over 4 devices"
        assert meshes[2] == "a mesh of shape (2, 3) needs 6 ranks; the group has 4"


def test_nccl_takes_one_card_a_rank_and_never_falls_back(monkeypatch):
    from repro_torch.launch import mesh

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="4 ranks on this host but 1 GPU"):
        mesh.init_from_env(None)
    assert not torch.distributed.is_initialized()


def test_bundles_refuse_what_has_no_torch_form():
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    bundle = steps.StepBundle(fn=None, args_abstract=(), in_shardings=(), out_shardings=None)
    with pytest.raises(NotImplementedError, match="ROADMAP 13c"):
        bundle.lower()
    assert bundle.jit() is bundle
    for arch in ("xlstm-1.3b", "zamba2-2.7b", "internvl2-26b", "seamless-m4t-large-v2"):
        model = build_model(_tcfg(arch), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP 13c"):
            steps.build_decode_step(model, None, _shape("decode", 8, 2))


# ----------------------------------------------------------------------
# the launchers under torchrun
# ----------------------------------------------------------------------
def _torchrun(args, tmp):
    from _subproc import subprocess_env

    env = subprocess_env(OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "4", *args], capture_output=True, text=True,
                          timeout=240, env=env, cwd=".")


def test_train_launcher_on_2x2_prints_the_references_lines_and_resumes_1x1(tmp_path):
    from _subproc import subprocess_env

    common = ["--arch", "minicpm-2b", "--reduced", "--seq-len", "16", "--global-batch", "8",
              "--log-every", "1", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
              "--device", "cpu"]
    one = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *common, "--steps",
                          "2", "--mesh", "1x1"], capture_output=True, text=True, timeout=240,
                         env=subprocess_env(), cwd=".")
    assert one.returncode == 0, one.stdout + one.stderr
    res = _torchrun(["-m", "repro_torch.launch.train", *common, "--steps", "4", "--mesh",
                     "2x2"], tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == ("training minicpm-2b on mesh{'data': 2, 'model': 2} over 4 devices; "
                        "schedule=wsd")
    assert lines[1] == "auto-resumed from step 2"
    assert [ln.split()[:2] for ln in lines[2:4]] == [["step", "2"], ["step", "3"]]
    assert lines[-1] == "done" and len(lines) == 5  # rank 0 alone prints


def test_serve_launcher_on_2x2_gives_the_one_device_private_head_summary(tmp_path):
    from _subproc import subprocess_env

    common = ["-m", "repro_torch.launch.serve", "--arch", "mistral-nemo-12b", "--reduced",
              "--private-head", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
              "--gen-len", "4"]
    one = subprocess.run([sys.executable, *common], capture_output=True, text=True, timeout=240,
                         env=subprocess_env(), cwd=".")
    assert one.returncode == 0, one.stdout + one.stderr
    res = _torchrun([*common, "--mesh", "2x2"], tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    lines, want = res.stdout.splitlines(), one.stdout.splitlines()
    assert lines[0] == "serving mistral-nemo-12b on mesh{'data': 2, 'model': 2} over 4 devices"
    assert len(lines) == len(want) == 4
    # the protocol's replays and simulated latencies; the logit error
    # depends on the bfloat16 trunk's roundings, which the shards change
    assert lines[3].split(", max |logit err|")[0] == want[3].split(", max |logit err|")[0]
