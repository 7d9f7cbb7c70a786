"""The vlm, encdec, ssm and hybrid families on a (data, model) mesh of gloo
ranks against the JAX package: shared by ``test_torch_mesh_families_*.py``.

``run_families(archs, tmp)`` runs, for each reduced arch at float32
compute, from the reference's weights (every zero-initialised leaf drawn
from seeded normals first, so the LoRA, the biases and the gates carry
gradients):

* the reference's train step (one step, 2 micro-steps on 2x2, 4 on 1x1)
  on a 1x1 mesh in this process and on 2x2 in one subprocess with four
  host devices, with its addressable shard shapes;
* on 4 spawned gloo ranks (``_torch_ranks``): the port's train step on
  2x2 with each rank's local shard shapes; the sharded prefill and 3
  decode steps at batch 4; for the recurrent families the long-context
  decode bundle (batch 1, below the data axis) from caches prefilled on
  one rank, and the collectives of a prefill at two lengths;
* the same serving on one rank of the port, in this process.

Every side starts from the same numpy inputs.
"""
import dataclasses
import pickle
import subprocess
import sys
import textwrap

import numpy as np

from _torch_ranks import run_ranks

F32 = dict(rtol=1e-4, atol=2e-4)
# caches: test_torch_mesh.py's for the attention families; the recurrent
# families' float32 drift through the trunk, test_torch_recurrent.py's
CACHE = dict(rtol=2.0**-7, atol=1e-6)
RECURRENT_CACHE = dict(rtol=2.0**-7, atol=2e-4)
# an element whose gradient is below this share of its leaf's largest has a
# first AdamW update lr g / (|g| + eps) set by the gradient's roundings (|g|
# near eps = 1e-8): there the step is held to its bound, 2 lr, instead
GRAD_FLOOR = 1e-5
SEQ, GB, MBS = 16, 8, 2
SERVE_B, PROMPT, GEN, EXTRA = 4, 16, 3, 4
TRAIN_KW = dict(lr=3e-3, schedule="cosine", total_steps=20, microbatch_seqs=MBS)
ZERO_INIT_SCALE = 0.5  # the normals that replace zero-initialised leaves
LONG = ("xlstm-1.3b", "zamba2-2.7b")  # the sub-quadratic archs: long_500k


def tcfg(arch, dtype="float32"):
    from repro_torch import configs

    return dataclasses.replace(configs.reduced(configs.get_config(arch)), compute_dtype=dtype)


def shape(kind="train", seq=SEQ, b=GB):
    from repro_torch.configs import SHAPES

    return dataclasses.replace(SHAPES["train_4k"], kind=kind, seq_len=seq, global_batch=b)


def full(tree):
    from repro_torch.models.common import map_tree

    return map_tree(lambda _, x: (x.full_tensor() if hasattr(x, "full_tensor") else x)
                    .detach().float().numpy(), tree)


def f32(tree):
    from repro_torch.models.common import map_tree

    return map_tree(lambda _, a: a.float() if a.is_floating_point() else a, tree)


def model_on(mesh, cfg, np_params, train=True):
    from repro_torch import convert
    from repro_torch.launch import steps
    from repro_torch.models import build_model

    model = build_model(cfg, device="cpu", train=train)
    model.load_state_dict(convert.decoder_params_from_reference(cfg, np_params))
    if mesh is not None:
        steps.place_params(model, mesh)
    return model


def nonzero(cfg, params, seed=7):
    """``params`` (numpy) with every ``init="zeros"`` leaf drawn from
    seeded normals."""
    from repro_torch.models import registry
    from repro_torch.models.common import iter_leaves, map_tree

    kinds = {n: i.init for n, i in iter_leaves(registry.params_abstract(cfg))}
    rng = np.random.default_rng(seed)

    def leaf(name, a):
        a = np.asarray(a, np.float32)
        return (rng.normal(size=a.shape) * ZERO_INIT_SCALE).astype(np.float32) \
            if kinds[name] == "zeros" else a

    return map_tree(leaf, params)


def batch_for(cfg, kind, b, t, seed):
    """Numpy inputs of ``registry.batch_spec``'s shapes (float32 patches
    and frames), labels for ``train``."""
    from repro_torch.models import registry

    rng = np.random.default_rng(seed)
    out = {}
    for name, s in registry.batch_spec(cfg, shape(kind, t, b)).items():
        if name in ("patches", "frames"):
            out[name] = rng.normal(size=s.shape).astype(np.float32)
        else:
            out[name] = rng.integers(0, cfg.vocab_size, s.shape).astype(np.int32)
    return out


def decode_start(batch) -> int:
    """The first decode position after a prefill of ``batch``."""
    if "frames" in batch:
        return batch["frames"].shape[1]
    return batch["tokens"].shape[1] + (batch["patches"].shape[1] if "patches" in batch else 0)


def serve(prefill, decode, batch, caches, n, start):
    """A prefill and ``n`` greedy decode steps: (every step's logits, the
    caches).  ``prefill`` / ``decode`` return logits as tensors or
    DTensors."""
    whole = lambda x: (x.full_tensor() if hasattr(x, "full_tensor") else x).numpy()  # noqa: E731
    logits, caches = prefill(batch, caches)
    out = [whole(logits)]
    b = out[0].shape[0]
    tok = out[0][:, -1].argmax(-1).astype(np.int32)[:, None]
    for i in range(n):
        logits, caches = decode(tok, caches, np.full((b, 1), start + i, np.int32))
        out.append(whole(logits))
        tok = out[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
    return out, caches


# ----------------------------------------------------------------------
# the rank job: repro_torch and numpy only
# ----------------------------------------------------------------------
def families_job(_, archs, inputs):
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import comm
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.common import iter_leaves, map_tree
    from repro_torch.train.optimizer import adamw_init

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    out = {"rank": dist.get_rank()}
    for arch in archs:
        inp = inputs[arch]
        cfg = tcfg(arch)
        model = model_on(mesh, cfg, inp["params"])
        bundle = steps.build_train_step(model, mesh, shape(), **TRAIN_KW)
        params = model.params()
        opt = adamw_init(params, bundle.opt_cfg)
        params, opt, m = bundle(params, opt, inp["batch"])
        res = {"metrics": {k: float(v) for k, v in m.items()},
               "shards": {n: tuple(p.to_local().shape) for n, p in iter_leaves(params)},
               "state": {"params": full(params), "mu": full(opt.mu), "nu": full(opt.nu)}}

        smodel = model_on(mesh, cfg, inp["params"], train=False)
        length = PROMPT + EXTRA
        pre = steps.build_prefill_step(smodel, mesh, shape("prefill", length, SERVE_B))
        dec = steps.build_decode_step(smodel, mesh, shape("decode", length, SERVE_B))
        logits, caches = serve(lambda b, c: pre(smodel.params(), b, c),
                               lambda t, c, p: dec(smodel.params(), c, t, p),
                               inp["serve"], f32(smodel.init_cache(SERVE_B, length)), GEN,
                               decode_start(inp["serve"]))
        res.update(serve=logits, caches=full(caches),
                   cache_placements={n: tuple(c.placements) for n, c in iter_leaves(caches)})
        if arch in LONG:
            long_caches = map_tree(lambda _, a: torch.as_tensor(a), inp["long_caches"])
            dec1 = steps.build_decode_step(smodel, mesh, shape("decode", length, 1))
            tok, pos, outs = inp["long_tok"], inp["long_pos"], []
            placed = None
            for i in range(GEN):
                logits1, long_caches = dec1(smodel.params(), long_caches, tok,
                                            np.full((1, 1), pos + i, np.int32))
                placed = placed or {n: tuple(c.placements) for n, c in iter_leaves(long_caches)}
                outs.append(logits1.full_tensor().numpy())
                tok = outs[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
            res.update(long=outs, long_caches=full(long_caches), long_placements=placed)
            # the collectives of a prefill at two lengths: none per time step
            counts = []
            for t in (PROMPT // 2, PROMPT):
                p2 = steps.build_prefill_step(smodel, mesh, shape("prefill", t, SERVE_B))
                with comm.CollectiveLog() as log:
                    p2(smodel.params(), {"tokens": inp["serve"]["tokens"][:, :t]},
                       f32(smodel.init_cache(SERVE_B, t)))
                counts.append(dict(log.counts))
            res["prefill_counts"] = counts
        out[arch] = res
    return out


# ----------------------------------------------------------------------
# the reference
# ----------------------------------------------------------------------
REF_2X2 = """
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import SHAPES, get_config, reduced
from repro.launch.mesh import make_mesh
from repro.launch import steps
from repro.models import build_model
from repro.train.optimizer import AdamWConfig, adamw_init

inp = pickle.load(open(sys.argv[1], "rb"))
mesh = make_mesh((2, 2), ("data", "model"))
order = {d.id: i for i, d in enumerate(mesh.devices.flat)}
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=inp["seq"], global_batch=inp["gb"])
out = {}
for arch, a in inp["archs"].items():
    cfg = dataclasses.replace(reduced(get_config(arch)), compute_dtype="float32")
    bundle = steps.build_train_step(build_model(cfg), mesh, shape, **inp["kw"])
    params = jax.tree.map(jnp.asarray, a["params"])
    opt = adamw_init(params, AdamWConfig(lr=None))
    with mesh:
        params = jax.device_put(params, bundle.in_shardings[0])
        opt = jax.device_put(opt, bundle.in_shardings[1])
        params, opt, m = bundle.jit()(params, opt, a["batch"])
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
    out[arch] = {"metrics": {k: float(v) for k, v in m.items()},
                 "params": jax.tree.map(np.asarray, params),
                 "mu": jax.tree.map(np.asarray, opt.mu), "nu": jax.tree.map(np.asarray, opt.nu),
                 "shards": shards}
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def run_families(archs, tmp):
    """Every run the families' tests compare, once per module."""
    import jax

    from _subproc import subprocess_env
    from repro.configs import SHAPES, get_config, reduced
    from repro.launch import steps as rsteps
    from repro.models import build_model as rbuild
    from repro.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.models.common import map_tree

    inputs, ref11 = {}, {}
    for i, arch in enumerate(archs):
        rcfg = dataclasses.replace(reduced(get_config(arch)), compute_dtype="float32")
        cfg = tcfg(arch)
        params = nonzero(cfg, jax.tree.map(np.asarray, rbuild(rcfg).init(jax.random.PRNGKey(0))))
        inputs[arch] = {"params": params, "batch": batch_for(cfg, "train", GB, SEQ, 10 + i),
                        "serve": batch_for(cfg, "prefill", SERVE_B, PROMPT, 20 + i)}
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump({"archs": {a: {"params": v["params"], "batch": v["batch"]}
                               for a, v in inputs.items()},
                     "seq": SEQ, "gb": GB, "kw": TRAIN_KW}, f)
    ref22 = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF_2X2), str(tmp / "ref_in.pkl"),
         str(tmp / "ref_out.pkl")], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=subprocess_env(XLA_FLAGS="--xla_force_host_platform_device_count=4"), cwd=".")

    one = {}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    for arch in archs:
        rcfg = dataclasses.replace(reduced(get_config(arch)), compute_dtype="float32")
        bundle = rsteps.build_train_step(rbuild(rcfg), mesh, dataclasses.replace(
            SHAPES["train_4k"], seq_len=SEQ, global_batch=GB), **TRAIN_KW)
        params = jax.tree.map(jax.numpy.asarray, inputs[arch]["params"])
        with mesh:
            rp, ro, m = bundle.jit()(params, adamw_init(params, AdamWConfig(lr=None)),
                                     inputs[arch]["batch"])
        ref11[arch] = {"metrics": {k: float(v) for k, v in m.items()},
                       "params": jax.tree.map(np.asarray, rp),
                       "mu": jax.tree.map(np.asarray, ro.mu), "nu": jax.tree.map(np.asarray, ro.nu)}

        # serving on one rank of the port
        cfg = tcfg(arch)
        model = model_on(None, cfg, inputs[arch]["params"], train=False)
        length = PROMPT + EXTRA
        batch = inputs[arch]["serve"]
        logits, caches = serve(model.prefill, model.decode_step, batch,
                               f32(model.init_cache(SERVE_B, length)), GEN, decode_start(batch))
        one[arch] = {"serve": logits, "caches": full(caches)}
        if arch in LONG:
            lg, lc = model.prefill({"tokens": batch["tokens"][:1]}, f32(model.init_cache(1, length)))
            tok = lg[:, -1].argmax(-1).int().numpy()[:, None]
            inputs[arch].update(long_caches=map_tree(lambda _, a: a.numpy(), lc), long_tok=tok,
                                long_pos=PROMPT)
            outs = []
            for i in range(GEN):
                lg, lc = model.decode_step(tok, lc, np.full((1, 1), PROMPT + i, np.int32))
                outs.append(lg.numpy())
                tok = outs[-1][:, -1].argmax(-1).astype(np.int32)[:, None]
            one[arch].update(long=outs, long_caches=full(lc))

    ranks = run_ranks(4, tmp, families_job, tuple(archs), inputs)
    out, err = ref22.communicate(timeout=300)
    assert ref22.returncode == 0, out + err
    with open(tmp / "ref_out.pkl", "rb") as f:
        ref22 = pickle.load(f)
    return dict(ref11=ref11, ref22=ref22, ranks=ranks, one=one)


def leaves(tree):
    from repro_torch.models.common import iter_leaves

    return dict(iter_leaves(tree))


def within(port, ref, rel):
    got = leaves(port)
    for name, r in leaves(ref).items():
        np.testing.assert_allclose(got[name], r, rtol=0, atol=rel * np.abs(r).max() + 1e-12,
                                   err_msg=name)


# ----------------------------------------------------------------------
# the checks the test files share
# ----------------------------------------------------------------------
def check_train(runs, arch, ref):
    want = (runs["ref11"] if ref == "1x1" else runs["ref22"])[arch]
    got = runs["ranks"][0][arch]
    for k in ("loss", "xent", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5, atol=1e-12,
                                   err_msg=k)
    for key in ("mu", "nu"):
        within(got["state"][key], want[key], 1e-4)
    lr = want["metrics"]["lr"]
    port = leaves(got["state"]["params"])
    for name, r in leaves(want["params"]).items():
        g = np.abs(leaves(want["mu"])[name])
        set_by_grad = g >= GRAD_FLOOR * g.max()
        np.testing.assert_allclose(port[name][set_by_grad], r[set_by_grad], rtol=0,
                                   atol=1e-4 * np.abs(r).max() + 1e-12, err_msg=name)
        assert np.abs(port[name] - r)[~set_by_grad].max(initial=0.0) <= 2 * lr, name


def check_shards(runs, arch):
    ref = runs["ref22"][arch]["shards"]
    for out in runs["ranks"]:
        rank, shards = out["rank"], out[arch]["shards"]
        assert sorted(shards) == sorted(ref)
        for name, s in shards.items():
            assert s == ref[name][rank], (name, rank, s, ref[name][rank])


def close_logits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **F32)


def close_caches(got, want, tol):
    got = leaves(got)
    assert sorted(got) == sorted(leaves(want))
    for name, w in leaves(want).items():
        np.testing.assert_allclose(got[name], w, **tol, err_msg=name)


def check_serve(runs, arch):
    got, want = runs["ranks"][0][arch], runs["one"][arch]
    close_logits(got["serve"], want["serve"])
    close_caches(got["caches"], want["caches"], RECURRENT_CACHE if arch in LONG else CACHE)
