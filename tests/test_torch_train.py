"""The port's training path against the JAX package's, on the same inputs:
the losses and their gradients (``models/common.py``, ``lm.decoder_loss``,
``lm.encdec_loss``, ``registry.loss`` and ``Model.loss``), the remat
policies, AdamW and the schedules (``train/optimizer.py``), gradient
compression (``train/grad_compress.py``), ``SyntheticLM``
(``data/pipeline.py``), checkpoints (``checkpoint/manager.py``) and the
train step (``launch/steps.py``).

The models are each family's ``reduced`` config (the reference's smoke
scale: 4 layers, d_model 64, vocab 256) initialised with
``jax.random.PRNGKey(0)`` and carried into a trainable port model by
``convert``; the optimizer, checkpoint and train-step tests use the
reference tests' ``_tiny_model`` (2 layers, d_model 32, vocab 64) where
they mirror them.  Inputs come from numpy with fixed seeds; the
reference's gradients come from ``jax.value_and_grad`` under ``jit``.

Tolerances, each with its reason:

* float32 compute (``GRAD_F32``): every gradient leaf within 1e-4 of
  that leaf's largest |reference| entry, and the loss within 1e-5
  relative: one float32 rounding per operation, summed in other orders.
  Observed: at most 4e-5 (Zamba2), under 6e-6 elsewhere.
* bfloat16 compute: the loss within 2**-5 relative (observed under
  1e-3).  For the gradients, each framework rounds to bfloat16 at its
  own points (XLA fuses elementwise chains and rounds once; PyTorch
  rounds after each op), and through four layers of backward pass each
  side's bfloat16 gradient is 2-30 % (of a leaf's largest entry) away
  from the float32 one: the reference's own bfloat16 gradient is as far
  from its float32 gradient as the port's is from the reference's.
  So each leaf's bfloat16 gradient is held to be as accurate as the
  reference's: its Frobenius distance from the reference's float32
  gradient at most ``BF16_GRAD_RATIO`` times the reference bfloat16
  gradient's own distance.  Observed ratios: 0.98-1.19.
* remat policies: the same gradients, exactly (the recomputation runs
  the same CPU kernels on the same inputs).
* AdamW, schedules, compression scales: float32 rounding (``F32_ULP``:
  rtol 4e-7, a few ulps), since XLA and PyTorch may differ in the last
  bit of ``pow``, ``cos``, ``exp`` and a division; the int8 ``q`` and
  the synthetic batches exactly.
* train step: metrics within 1e-5 relative; parameters within 2 * sum of
  the step's learning rates (an entry whose gradient is near zero can
  take ``m / sqrt(v)`` of either sign) with the share of entries beyond
  1e-6 below 1e-3.  Observed: metrics within 4e-7, no entry beyond 1e-6
  (the largest difference 1.4e-7).
* checkpoints and resume: exact.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as rmgr
from repro.configs import ARCH_NAMES, SHAPES, get_config, reduced
from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.launch import steps as rsteps
from repro.models import build_model as rbuild
from repro.models import common as rcm
from repro.train import grad_compress as rgc
from repro.train import optimizer as ropt
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tcm
from repro_torch.models import registry as treg
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt

FAMILIES = ("minicpm-2b", "deepseek-v2-lite-16b", "internvl2-26b", "seamless-m4t-large-v2",
            "xlstm-1.3b", "zamba2-2.7b")
GRAD_F32 = 1e-4
BF16_GRAD_RATIO = 2.0
F32_ULP = dict(rtol=4e-7, atol=0.0)


def _cfgs(arch, dtype="float32", **kw):
    ref = dataclasses.replace(reduced(get_config(arch)), compute_dtype=dtype, **kw)
    port = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), compute_dtype=dtype,
                               **kw)
    return ref, port


def _batch(cfg, seed=3, b=2, t=16):
    """tokens and labels (the last of each row -1, ignored); a vlm's 4
    patch embeddings, an encoder-decoder's 12 frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    out["labels"][:, -1] = -1
    if cfg.family == "vlm":
        out["patches"] = rng.normal(size=(b, 4, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(b, 12, cfg.d_model)).astype(np.float32)
    return out


_REF = {}
_PARAMS = {}


def _reference(arch, dtype):
    """(numpy params, batch, loss, metrics, {name: gradient}) of the
    reference's ``value_and_grad(model.loss)``, made once; the weights
    (float32 whatever the compute dtype) drawn once per arch."""
    if (arch, dtype) not in _REF:
        rc, _ = _cfgs(arch, dtype)
        model = rbuild(rc)
        if arch not in _PARAMS:
            _PARAMS[arch] = jax.jit(model.init)(jax.random.PRNGKey(0))
        params = _PARAMS[arch]
        batch = _batch(rc)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(params,
                                                                                        batch)
        _REF[arch, dtype] = (jax.tree.map(np.asarray, params), batch, float(loss),
                             {k: float(v) for k, v in metrics.items()},
                             dict(tcm.iter_leaves(jax.tree.map(np.asarray, grads))))
    return _REF[arch, dtype]


def _port_model(tc, np_params, device="cpu"):
    model = tbuild(tc, device=device, train=True)
    model.load_state_dict(convert.decoder_params_from_reference(tc, np_params))
    return model


def _port_grads(arch, dtype, **cfg_kw):
    """(loss, metrics, {name: gradient}) of the port's ``Model.loss`` on
    the reference's weights and batch."""
    np_params, batch = _reference(arch, dtype)[:2]
    model = _port_model(_cfgs(arch, dtype, **cfg_kw)[1], np_params)
    loss, metrics = model.loss(batch)
    loss.backward()
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {name: p.grad.numpy() for name, p in model.named_parameters()})


# ----------------------------------------------------------------------
# the losses
# ----------------------------------------------------------------------
def test_softmax_xent_with_z_loss_against_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    cot = rng.normal(size=(3, 5)).astype(np.float32)
    for z in (0.0, 1e-3):
        f = lambda lg: jnp.sum(rcm.softmax_xent(lg, labels, z) * cot)  # noqa: E731
        ref, ref_g = jax.value_and_grad(f)(logits)
        x = torch.tensor(logits, requires_grad=True)
        got = (tcm.softmax_xent(x, torch.tensor(labels), z) * torch.tensor(cot)).sum()
        got.backward()
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("chunk", [8, 64])
def test_chunked_softmax_xent_against_jax(chunk):
    """21 tokens in chunks of 8 (the last padded with -1 labels) or one
    of 21; 37 real of 40 padded vocabulary columns; -1 labels ignored:
    the loss and both gradients (hidden states and head)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 16)).astype(np.float32)
    head = rng.normal(size=(16, 40)).astype(np.float32) * 0.3
    labels = rng.integers(0, 37, (3, 7)).astype(np.int32)
    labels[0, 2] = labels[2, 6] = -1

    def f(xx, hh):
        return rcm.chunked_softmax_xent(xx, hh, labels, logit_scale=0.7, chunk=chunk, n_vocab=37)

    ref, (gx, gh) = jax.value_and_grad(f, argnums=(0, 1))(x, head)
    tx, th = torch.tensor(x, requires_grad=True), torch.tensor(head, requires_grad=True)
    got = tcm.chunked_softmax_xent(tx, th, torch.tensor(labels), logit_scale=0.7, chunk=chunk,
                                   n_vocab=37)
    got.backward()
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_loss_and_every_gradient_at_float32(arch):
    _, _, ref_loss, ref_metrics, ref_grads = _reference(arch, "float32")
    loss, metrics, grads = _port_grads(arch, "float32")
    assert set(grads) == set(ref_grads)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    np.testing.assert_allclose(metrics["xent"], ref_metrics["xent"], rtol=1e-5)
    np.testing.assert_allclose(metrics["aux"], ref_metrics["aux"], rtol=1e-5, atol=1e-9)
    for name, ref in ref_grads.items():
        err = np.abs(grads[name] - ref).max()
        assert err <= GRAD_F32 * np.abs(ref).max(), (name, err, np.abs(ref).max())
    if arch == "deepseek-v2-lite-16b":  # the MoE aux term and its router gradient
        assert metrics["aux"] > 0 and np.abs(grads["layers.moe.router"]).max() > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_loss_and_gradients_at_bfloat16(arch):
    _, _, ref_loss, _, ref_grads = _reference(arch, "bfloat16")
    truth = _reference(arch, "float32")[4]
    loss, _, grads = _port_grads(arch, "bfloat16")
    np.testing.assert_allclose(loss, ref_loss, rtol=2.0**-5)
    for name, t in truth.items():
        ref_err = np.linalg.norm(ref_grads[name] - t)
        port_err = np.linalg.norm(grads[name] - t)
        assert port_err <= BF16_GRAD_RATIO * ref_err, (name, port_err, ref_err)


@pytest.mark.parametrize("arch", ["minicpm-2b", "seamless-m4t-large-v2", "xlstm-1.3b",
                                  "zamba2-2.7b"])
def test_remat_policies_give_the_same_gradients(arch):
    """``none``, ``full`` and ``dots`` on the trunk of each assembly
    (``_trunk``; ``encode`` and ``decode_stack``; the xLSTM group; the
    Mamba2 layer)."""
    grads = {policy: _port_grads(arch, "float32", remat_policy=policy)
             for policy in ("none", "full", "dots")}
    for policy in ("full", "dots"):
        assert grads[policy][0] == grads["none"][0]
        for name, g in grads["none"][2].items():
            np.testing.assert_array_equal(grads[policy][2][name], g, err_msg=f"{policy} {name}")


def test_remat_wraps_only_under_grad():
    calls = []

    def fn(x):
        calls.append(torch.is_grad_enabled())
        return x * x

    x = torch.ones(3, requires_grad=True)
    wrapped = tcm.remat_wrap(fn, "full")
    with torch.no_grad():
        wrapped(x)
    wrapped(x).sum().backward()  # the forward, then its recomputation
    assert calls == [False, True, True]
    assert tcm.remat_wrap(fn, "none") is fn
    with pytest.raises(ValueError):
        tcm.remat_wrap(fn, "some")


def test_trainable_model_holds_float32_params_and_serving_keeps_its_dtypes():
    _, tc = _cfgs("minicpm-2b", "bfloat16")
    train, serve = tbuild(tc, device="cpu", train=True), tbuild(tc, device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad for p in train.parameters())
    stored = dict(tcm.iter_leaves(treg.lm.stored_infos(tc, treg.params_abstract(tc))))
    assert all(p.dtype == stored[n].dtype and not p.requires_grad
               for n, p in serve.named_parameters())
    want = tcm.abstract(treg.params_abstract(tc))
    assert {n: (tuple(s.shape), s.dtype) for n, s in tcm.iter_leaves(want)} == {
        n: (tuple(p.shape), p.dtype) for n, p in train.named_parameters()}


# ----------------------------------------------------------------------
# optimizer, schedules, compression
# ----------------------------------------------------------------------
def _tree(rng, scale=1.0):
    return {"layers": {"ln_attn": rng.normal(size=(6,)).astype(np.float32) * scale,
                       "attn": {"wq": rng.normal(size=(6, 8)).astype(np.float32) * scale,
                                "bq": rng.normal(size=(8,)).astype(np.float32) * scale}},
            "embed": rng.normal(size=(10, 6)).astype(np.float32) * scale}


@pytest.mark.parametrize("grad_scale", [1e-2, 30.0])  # clip inactive, active
def test_adamw_update_five_steps_against_the_reference(grad_scale):
    rng = np.random.default_rng(5)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(5)]
    rcfg = ropt.AdamWConfig(lr=ropt.get_schedule("wsd", 3e-3, 20))
    tcfg = topt.AdamWConfig(lr=topt.get_schedule("wsd", 3e-3, 20))
    rp = jax.tree.map(jnp.asarray, params)
    ro = ropt.adamw_init(rp, rcfg)
    tp = tcm.map_tree(lambda _, a: torch.tensor(a), params)
    to = topt.adamw_init(tp, tcfg)
    for g in grads:
        rp, ro, rm = ropt.adamw_update(jax.tree.map(jnp.asarray, g), ro, rp, rcfg)
        tp, to, tm = topt.adamw_update(tcm.map_tree(lambda _, a: torch.tensor(a), g), to, tp, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]), **F32_ULP)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), **F32_ULP)
    assert int(to.step) == int(ro.step) == 5
    for ref_tree, port_tree in ((rp, tp), (ro.mu, to.mu), (ro.nu, to.nu)):
        ref = dict(tcm.iter_leaves(jax.tree.map(np.asarray, ref_tree)))
        for name, x in tcm.iter_leaves(port_tree):
            np.testing.assert_allclose(x.numpy(), ref[name], rtol=2e-6, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decay_mask_equal_leaf_for_leaf(arch):
    infos = rbuild(reduced(get_config(arch))).abstract_params()
    ref = dict(tcm.iter_leaves(ropt._decay_mask(infos, ropt.AdamWConfig(lr=None).no_decay)))
    port_infos = treg.params_abstract(tconfigs.reduced(tconfigs.get_config(arch)))
    port = dict(tcm.iter_leaves(topt._decay_mask(port_infos, topt.AdamWConfig(lr=None).no_decay)))
    assert port == ref
    assert not all(port.values()) and any(port.values())


@pytest.mark.parametrize("name,total", [("cosine", 100), ("cosine", 7), ("wsd", 100), ("wsd", 4),
                                        ("wsd", 230)])
def test_schedules_at_every_step(name, total):
    ref, port = ropt.get_schedule(name, 3e-4, total), topt.get_schedule(name, 3e-4, total)
    for step in range(total + 2):
        np.testing.assert_allclose(float(port(torch.tensor(step, dtype=torch.int32))),
                                   float(ref(jnp.int32(step))), **F32_ULP)
    for ref_fn, port_fn in ((ropt.cosine_schedule(1.0, 10, 100), topt.cosine_schedule(1.0, 10, 100)),
                            (ropt.wsd_schedule(1.0, 10, 80, 10), topt.wsd_schedule(1.0, 10, 80, 10))):
        for step in (0, 5, 10, 50, 95, 100, 120):
            np.testing.assert_allclose(float(port_fn(step)), float(ref_fn(jnp.int32(step))),
                                       **F32_ULP)


def test_grad_compress_and_error_feedback_against_the_reference():
    rng = np.random.default_rng(2)
    like = {"a": np.zeros((1000,), np.float32), "b": {"w": np.zeros((7, 9), np.float32)}}
    rerr = rgc.init_error(jax.tree.map(jnp.asarray, like))
    terr = tgc.init_error(tcm.map_tree(lambda _, a: torch.tensor(a), like))
    for step in range(6):
        g = tcm.map_tree(lambda _, a: rng.normal(size=a.shape).astype(np.float32), like)
        rcomp, rerr = rgc.compress_with_feedback(jax.tree.map(jnp.asarray, g), rerr)
        tcomp, terr = tgc.compress_with_feedback(tcm.map_tree(lambda _, a: torch.tensor(a), g),
                                                 terr)
        rq = dict(tcm.iter_leaves(jax.tree.map(np.asarray, rcomp.q)))
        rs = dict(tcm.iter_leaves(jax.tree.map(np.asarray, rcomp.scale)))
        for name, q in tcm.iter_leaves(tcomp.q):
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.numpy(), rq[name], err_msg=f"step {step} {name}")
        for name, s in tcm.iter_leaves(tcomp.scale):
            np.testing.assert_array_max_ulp(s.numpy(), rs[name], maxulp=1)
        g_t = tcm.map_tree(lambda _, a: torch.tensor(a), g)
        back_r = dict(tcm.iter_leaves(jax.tree.map(np.asarray, rgc.decompress(rcomp, g))))
        for name, x in tcm.iter_leaves(tgc.decompress(tcomp, g_t)):
            assert x.shape == dict(tcm.iter_leaves(g_t))[name].shape
            np.testing.assert_allclose(x.numpy(), back_r[name], **F32_ULP)
        ref_err = dict(tcm.iter_leaves(jax.tree.map(np.asarray, rerr)))
        for name, e in tcm.iter_leaves(terr):
            np.testing.assert_allclose(e.numpy(), ref_err[name], rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------------------
# data and checkpoints
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed,count", [(0, 1), (7, 2), (123, 4)])
def test_synthetic_lm_batches_are_bit_identical(seed, count):
    cfg = dict(vocab_size=300, seq_len=24, global_batch=8, seed=seed)
    for index in range(count):
        ref = RSyntheticLM(RDataConfig(**cfg), process_index=index, process_count=count)
        port = SyntheticLM(DataConfig(**cfg), process_index=index, process_count=count)
        np.testing.assert_array_equal(port._perm, ref._perm)
        for step in (0, 1, 17):
            rb, pb = ref.batch(step), port.batch(step)
            for key in ("tokens", "labels"):
                assert pb[key].dtype == rb[key].dtype
                np.testing.assert_array_equal(pb[key], rb[key])
    with pytest.raises(ValueError):
        SyntheticLM(DataConfig(**cfg), process_count=3)


def _state(step):
    return {
        "params": {"w": torch.full((4, 4), float(step)), "b": torch.arange(3.0)},
        "opt": {"mu": {"w": torch.zeros((4, 4)), "b": torch.zeros(3)}},
        "step": torch.tensor(step, dtype=torch.int32),
    }


def test_checkpoint_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(5, _state(5), meta={"config": "tiny"})
    step, state = mgr.restore(_state(0))
    assert step == 5
    assert float(state["params"]["w"][0, 0]) == 5.0
    assert int(state["step"]) == 5 and state["step"].dtype == torch.int32


def test_checkpoint_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_atomic_tmp_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _state(1))
    (tmp_path / "tmp.99").mkdir()  # a crash mid-write: the stray tmp dir is not listed
    assert mgr.all_steps() == [1]
    step, _ = mgr.restore(_state(0))
    assert step == 1


def test_checkpoint_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 2, 3):
        mgr.save(s, _state(s))
    step, state = mgr.restore(_state(0), step=2)
    assert step == 2 and float(state["params"]["w"][0, 0]) == 2.0


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    bad = _state(0)
    bad["params"]["w"] = torch.zeros((2, 2))
    with pytest.raises(ValueError):
        mgr.restore(bad)


def test_checkpoint_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(_state(0))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    """A training state (params and ``AdamWState``) saved by one package
    restores exactly in the other: the same files and keys."""
    rng = np.random.default_rng(4)
    params = _tree(rng)
    mu, nu = _tree(rng), _tree(rng, 0.1)
    ref_state = {"params": jax.tree.map(jnp.asarray, params),
                 "opt": ropt.AdamWState(step=jnp.int32(3), mu=jax.tree.map(jnp.asarray, mu),
                                        nu=jax.tree.map(jnp.asarray, nu))._asdict()}
    to_t = lambda tree: tcm.map_tree(lambda _, a: torch.tensor(a), tree)  # noqa: E731
    port_state = {"params": to_t(params),
                  "opt": topt.AdamWState(step=torch.tensor(3, dtype=torch.int32), mu=to_t(mu),
                                         nu=to_t(nu))._asdict()}
    if writer == "reference":
        rmgr.CheckpointManager(str(tmp_path)).save(3, ref_state)
        zero = tcm.map_tree(lambda _, a: torch.zeros_like(a), port_state)
        step, got = CheckpointManager(str(tmp_path)).restore(zero)
        flat = {k: np.asarray(v) for k, v in rmgr._flatten(ref_state).items()}
        got_flat = convert.train_state_to_reference(got["params"], topt.AdamWState(**got["opt"]))
    else:
        CheckpointManager(str(tmp_path)).save(3, port_state)
        zero = jax.tree.map(jnp.zeros_like, ref_state)
        step, got = rmgr.CheckpointManager(str(tmp_path)).restore(zero)
        flat = convert.train_state_to_reference(port_state["params"],
                                                topt.AdamWState(**port_state["opt"]))
        got_flat = rmgr._flatten(got)
    assert step == 3
    assert sorted(got_flat) == sorted(flat)
    for key, value in flat.items():
        assert np.asarray(got_flat[key]).dtype == value.dtype, key
        np.testing.assert_array_equal(np.asarray(got_flat[key]), value, err_msg=key)


# ----------------------------------------------------------------------
# the train step
# ----------------------------------------------------------------------
def _tiny(dtype="float32"):
    kw = dict(num_layers=2, vocab_size=64, d_model=32, num_heads=4, num_kv_heads=4, head_dim=8,
              d_ff=64, compute_dtype=dtype)
    return (dataclasses.replace(reduced(get_config("minicpm-2b")), **kw),
            dataclasses.replace(tconfigs.reduced(tconfigs.get_config("minicpm-2b")), **kw))


def _ref_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def test_n_micro_equals_the_reference_over_a_grid():
    rc, tc = _tiny()
    model, mesh = rbuild(rc), _ref_mesh()
    tmodel = tbuild(tc, device="cpu", train=True)
    for gb in (1, 2, 6, 8, 12):
        for mbs in (1, 2, 3, 5, 16):
            shape = dataclasses.replace(SHAPES["train_4k"], seq_len=8, global_batch=gb)
            fn = inspect.getclosurevars(rsteps.build_train_step(
                model, mesh, shape, microbatch_seqs=mbs).fn).nonlocals["fn"]
            want = inspect.getclosurevars(fn).nonlocals["n_micro"]
            port = tsteps.build_train_step(tmodel, None, shape, microbatch_seqs=mbs)
            assert port.n_micro == tsteps.n_micro_steps(gb, mbs) == want, (gb, mbs)


def _ref_run(rc, np_params, data, steps, shape, **kw):
    """The reference's train step (1x1 mesh, jitted) for ``steps``."""
    model, mesh = rbuild(rc), _ref_mesh()
    bundle = rsteps.build_train_step(model, mesh, shape, **kw)
    params = jax.tree.map(jnp.asarray, np_params)
    opt = ropt.adamw_init(params, ropt.AdamWConfig(lr=None))
    metrics = []
    with mesh:
        step = bundle.jit()
        for i in steps:
            params, opt, m = step(params, opt, data.batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
    return jax.tree.map(np.asarray, params), opt, metrics


def _port_run(tc, np_params, data, steps, shape, **kw):
    model = _port_model(tc, np_params)
    step = tsteps.build_train_step(model, None, shape, **kw)
    params = model.params()
    opt = topt.adamw_init(params, step.opt_cfg)
    metrics = []
    for i in steps:
        params, opt, m = step(params, opt, data.batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, opt, metrics


def test_three_train_steps_against_the_reference():
    rc, tc = _tiny()
    np_params = jax.tree.map(np.asarray, rbuild(rc).init(jax.random.PRNGKey(0)))
    data = SyntheticLM(DataConfig(vocab_size=64, seq_len=16, global_batch=8))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=8)
    kw = dict(lr=3e-3, schedule="cosine", total_steps=20, microbatch_seqs=2)
    ref_params, ref_opt, ref_m = _ref_run(rc, np_params, data, range(3), shape, **kw)
    params, opt, port_m = _port_run(tc, np_params, data, range(3), shape, **kw)
    for r, p in zip(ref_m, port_m):
        assert set(p) == set(r) == set(tsteps.METRICS)
        for k in r:
            np.testing.assert_allclose(p[k], r[k], rtol=1e-5, atol=1e-12, err_msg=k)
    bound = 2 * sum(m["lr"] for m in ref_m)
    ref = dict(tcm.iter_leaves(ref_params))
    beyond = total = 0
    for name, x in tcm.iter_leaves(params):
        diff = np.abs(x.detach().numpy() - ref[name])
        assert diff.max() <= bound, (name, diff.max(), bound)
        beyond += int((diff > 1e-6).sum())
        total += diff.size
    assert beyond / total < 1e-3, (beyond, total)
    carried = convert.opt_state_from_reference(tc, jax.tree.map(np.asarray, ref_opt._asdict()))
    assert int(carried.step) == int(opt.step) == 3
    for key in ("mu", "nu"):
        ref_moments = dict(tcm.iter_leaves(getattr(carried, key)))
        for name, x in tcm.iter_leaves(getattr(opt, key)):
            want = ref_moments[name].numpy()
            assert x.dtype == torch.float32
            np.testing.assert_allclose(x.numpy(), want, rtol=0,
                                       atol=1e-4 * np.abs(want).max() + 1e-12, err_msg=name)


def test_microbatched_step_equals_the_full_batch_step():
    """Grad accumulation is exact up to float32 rounding: 4 micro-steps
    of 2 sequences against one of 8 (every row has the same count of
    labelled tokens, so the mean of the micro-steps' means is the
    batch's mean)."""
    rc, tc = _tiny()
    np_params = jax.tree.map(np.asarray, rbuild(rc).init(jax.random.PRNGKey(0)))
    data = SyntheticLM(DataConfig(vocab_size=64, seq_len=16, global_batch=8))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=8)
    micro = _port_run(tc, np_params, data, [0], shape, microbatch_seqs=2)
    full = _port_run(tc, np_params, data, [0], shape, microbatch_seqs=8)
    np.testing.assert_allclose(micro[2][0]["loss"], full[2][0]["loss"], rtol=1e-6)
    np.testing.assert_allclose(micro[2][0]["grad_norm"], full[2][0]["grad_norm"], rtol=1e-5)
    full_params = dict(tcm.iter_leaves(full[0]))
    for name, x in tcm.iter_leaves(micro[0]):
        np.testing.assert_allclose(x.detach().numpy(), full_params[name].detach().numpy(),
                                   rtol=0, atol=2 * 3e-4 * 1e-2, err_msg=name)


def test_six_straight_steps_equal_three_saved_restored_and_three(tmp_path):
    rc, tc = _tiny()
    np_params = jax.tree.map(np.asarray, rbuild(rc).init(jax.random.PRNGKey(0)))
    data = SyntheticLM(DataConfig(vocab_size=64, seq_len=16, global_batch=4))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=16, global_batch=4)
    kw = dict(lr=1e-3, schedule="cosine", total_steps=100, microbatch_seqs=2)
    straight, straight_opt, _ = _port_run(tc, np_params, data, range(6), shape, **kw)

    model = _port_model(tc, np_params)
    step = tsteps.build_train_step(model, None, shape, **kw)
    params = model.params()
    opt = topt.adamw_init(params, step.opt_cfg)
    for i in range(3):
        params, opt, _ = step(params, opt, data.batch(i))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"params": params, "opt": opt._asdict()})
    fresh = _port_model(tc, np_params)
    params = fresh.params()
    saved_step, opt = tsteps.restore_train_state(mgr, params, topt.adamw_init(params, step.opt_cfg))
    assert saved_step == 3
    for i in range(3, 6):
        params, opt, _ = step(params, opt, data.batch(i))
    for (name, a), (_, b) in zip(tcm.iter_leaves(straight), tcm.iter_leaves(params)):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy(), err_msg=name)
    for (_, a), (_, b) in zip(tcm.iter_leaves(straight_opt.nu), tcm.iter_leaves(opt.nu)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_abstract_opt_state():
    _, tc = _tiny()
    abs_params = tcm.abstract(treg.params_abstract(tc))
    state = tsteps.abstract_opt_state(abs_params)
    assert state.step.shape == () and state.step.dtype == torch.int32
    for tree in (state.mu, state.nu):
        assert {n: (s.shape, s.dtype) for n, s in tcm.iter_leaves(tree)} == {
            n: (s.shape, torch.float32) for n, s in tcm.iter_leaves(abs_params)}
