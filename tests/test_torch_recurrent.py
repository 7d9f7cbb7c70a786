"""The port's recurrent families against the JAX package's, on the same
inputs: xLSTM (family ``ssm``: ``models/xlstm.py``) and Zamba2 (family
``hybrid``: Mamba2 in ``models/ssm.py``, the shared attention block and
both assemblies in ``models/hybrid.py``).

The reference models are ``reduced(xlstm-1.3b)`` (4 layers as 2 groups
of 1 sLSTM + 1 mLSTM, d_in 128, 4 heads of 32, chunk 16) and
``reduced(zamba2-2.7b)`` (4 Mamba2 layers, 8 heads of 16, state 16,
chunk 16; the shared block at layers 0 and 2 with LoRA rank 8),
initialised with ``jax.random.PRNGKey(0)``.  Every leaf the reference
initialises to zero (``b_if``, ``b_gates``, ``conv_b``, ``a_log``,
``dt_bias``, the LoRA ``b_q``) is overwritten with seeded normals before
the weights are carried into the port (``convert``), so a fault in the
term it feeds shows.  Inputs come from numpy with fixed seeds; the
reference is jitted; the port runs on the CPU.  The lengths T = 24, 34
and 17 take both chunk rules apart (mLSTM halves its chunk until it
divides T, Mamba2 steps it down by one: 8 and 12 at T = 24, 2 and 2 at
34, 1 and 1 at the prime 17), so the carried chunk state is used.

Tolerances, each with its reason:

* float32 compute (``F32``, rtol 1e-4, atol 2e-4): one float32
  rounding per operation, summed in another order (the port's sLSTM also
  multiplies all steps' inputs by ``w_gates`` at once).  Observed: below
  1e-5 relative on the scans, 3e-4 absolute on Zamba2's logits of
  magnitude 4, whose attention reads K/V through the bfloat16 cache.
* cache entries (``CACHE``): one bfloat16 ulp (2**-7 relative) plus
  ``F32``'s absolute 2e-4, as MLA's in ``tests/test_torch_moe.py``: a
  float32 K/V value that differs in its last bit can round to the
  neighbouring bfloat16 value, and a later layer's entries carry an
  earlier layer's drift.  Decode steps also run from the reference's own
  caches carried across, where ``F32`` holds alone.
* bfloat16 compute (``bf16_tol``, 2**-5 of the largest value): each
  framework rounds to bfloat16 at its own points (the SiLU, products,
  Mamba2's bfloat16 state).  Observed: ~2**-6 on the scans and the
  shared block.  The models are compared at float32: through four
  layers of exponential gating the bfloat16 roundings grow to 2-6% of
  the largest hidden value.
* shapes, dtypes, the -1e30 stabiliser fill, write positions, greedy
  tokens and refusal messages: exact.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.launch import serve as rserve
from repro.models import build_model as rbuild
from repro.models import common as rcm
from repro.models import hybrid as rhy
from repro.models import ssm as rssm
from repro.models import xlstm as rxl
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tcm
from repro_torch.models import hybrid as thy
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as txl
from test_torch_models import F32, _close, _np, bf16_tol

XLSTM, ZAMBA = "xlstm-1.3b", "zamba2-2.7b"
ARCHS = (XLSTM, ZAMBA)
CACHE = dict(rtol=2.0**-7, atol=2e-4)
B, T, GEN = 2, 34, 3
ZERO_INIT_SCALE = 0.5  # the normals that replace zero-initialised leaves


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(reduced(get_config(arch)), compute_dtype=dtype)


def _tcfg(arch, dtype="float32"):
    return dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), compute_dtype=dtype)


def _nonzero(infos, params, seed):
    """``params`` (numpy) with every ``init="zeros"`` leaf of ``infos``
    drawn from seeded normals."""
    rng = np.random.default_rng(seed)
    kinds = dict(tcm.iter_leaves(jax.tree.map(lambda i: i.init, infos,
                                              is_leaf=lambda x: isinstance(x, rcm.ParamInfo))))

    def leaf(name, a):
        a = np.asarray(a, np.float32)
        if kinds[name] == "zeros":
            return (rng.normal(size=a.shape) * ZERO_INIT_SCALE).astype(np.float32)
        return a

    return tcm.map_tree(leaf, params)


_PARAMS = {}


def _ref_params(arch):
    """(jax params, numpy params) of the reduced ``arch``, zero leaves
    randomised, made once."""
    if arch not in _PARAMS:
        rm = rbuild(_cfg(arch))
        npp = _nonzero(rm.abstract_params(), jax.tree.map(np.asarray, rm.init(jax.random.PRNGKey(0))), 7)
        _PARAMS[arch] = jax.tree.map(jnp.asarray, npp), npp
    return _PARAMS[arch]


def _pair(arch, dtype="float32"):
    tm = tbuild(_tcfg(arch, dtype), device="cpu")
    tm.load_state_dict(convert.decoder_params_from_reference(tm.cfg, _ref_params(arch)[1]))
    return rbuild(_cfg(arch, dtype)), tm


def _prompts(cfg, seed=1, b=B, t=T):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _caches_close(rc, tc, tol=CACHE, bf16=None):
    """Every leaf of two cache trees: the same names and dtypes, float
    leaves within ``tol`` (bfloat16 leaves within ``bf16`` where given),
    integer leaves (write positions) equal."""
    ref = dict(tcm.iter_leaves(jax.tree.map(np.asarray, rc)))
    port = dict(tcm.iter_leaves(tc))
    assert sorted(ref) == sorted(port)
    for name, x in ref.items():
        assert str(port[name].dtype).removeprefix("torch.") == str(x.dtype), name
        if port[name].is_floating_point():
            _close(x, port[name], **(bf16 if bf16 and port[name].dtype == torch.bfloat16 else tol))
        else:
            np.testing.assert_array_equal(x, port[name].numpy(), err_msg=name)


# ----------------------------------------------------------------------
# per module: the scans, the decode steps from their states, the shared block
# ----------------------------------------------------------------------
# name: (arch, reference params/scan/step, port scan/step)
MODULES = {
    "mlstm": (XLSTM, rxl.mlstm_params, rxl.mlstm_scan, rxl.mlstm_decode_step,
              txl.mlstm_scan, txl.mlstm_decode_step),
    "slstm": (XLSTM, rxl.slstm_params, rxl.slstm_scan, rxl.slstm_decode_step,
              txl.slstm_scan, txl.slstm_decode_step),
    "mamba": (ZAMBA, rssm.mamba_params, rssm.mamba_scan, rssm.mamba_decode_step,
              tssm.mamba_scan, tssm.mamba_decode_step),
}
_JIT = {}


def _jit(fn, cfg, **kw):
    key = (fn, cfg.compute_dtype, tuple(kw.items()))
    if key not in _JIT:
        _JIT[key] = jax.jit(lambda *a: fn(*a, cfg, **kw))
    return _JIT[key]


def _module_params(name, seed=3):
    """(reference numpy params, the port's tensors) of one block: seeded
    normals scaled as ``materialize`` scales them (norm weights near 1,
    zero-initialised leaves as ``_nonzero``)."""
    arch, params_fn = MODULES[name][:2]
    rng = np.random.default_rng(seed)

    def leaf(_, info):
        if info.init == "ones":
            return (1 + 0.1 * rng.normal(size=info.shape)).astype(np.float32)
        scale = {"small": 0.006, "zeros": ZERO_INIT_SCALE}.get(info.init, info.shape[0] ** -0.5)
        return (rng.normal(size=info.shape) * scale).astype(np.float32)

    p = tcm.map_tree(leaf, params_fn(_cfg(arch)))
    return p, tcm.map_tree(lambda _, a: torch.tensor(a), p)


def _tol(dtype, ref):
    return F32 if dtype == "float32" else dict(rtol=0, atol=bf16_tol(_np(ref)))


def _scan_pair(name, t, dtype, seed=None):
    """(reference, port) (out, states) of a scan over [B, t, d] normals."""
    arch, _, rscan, _, tscan, _ = MODULES[name]
    rp, tp = _module_params(name)
    x = np.random.default_rng(t if seed is None else seed).normal(
        size=(B, t, _cfg(arch).d_model)).astype(np.float32)
    ref = _jit(rscan, _cfg(arch, dtype), return_state=True)(
        jax.tree.map(jnp.asarray, rp), jnp.asarray(x).astype(dtype))
    port = tscan(tp, torch.tensor(x).to(getattr(torch, dtype)), _tcfg(arch, dtype), return_state=True)
    return ref, port


@pytest.mark.parametrize("t,mlstm_chunk,mamba_chunk", [(24, 8, 12), (34, 2, 2), (17, 1, 1), (8, 8, 8)])
def test_chunk_rules_are_the_references(t, mlstm_chunk, mamba_chunk):
    cfg = _tcfg(XLSTM)
    assert txl._chunk_len(cfg, t) == mlstm_chunk
    assert tssm._chunk_len(_tcfg(ZAMBA).ssm, t) == mamba_chunk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [24, 34, 17])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_scan_with_state_against_the_reference(name, t, dtype):
    """The block's output and final states (mLSTM ``c``/``n``/``m``,
    sLSTM ``c``/``n``/``h``/``m``, float32; Mamba2 ``state`` and the raw
    ``conv`` tail in the compute dtype)."""
    (rout, rst), (tout, tst) = _scan_pair(name, t, dtype)
    assert tout.dtype == getattr(torch, dtype) and tuple(tout.shape) == tuple(rout.shape)
    _close(rout, tout, **_tol(dtype, rout))
    assert sorted(rst) == sorted(tst)
    for key, r in rst.items():
        assert str(tst[key].dtype).removeprefix("torch.") == str(r.dtype), key
        _close(r, tst[key], **_tol(dtype, r))
    if name != "mamba":
        assert bool(torch.isfinite(tst["m"]).all()) and float(tst["m"].max()) > -1e29


def test_mamba_conv_tail_is_zero_padded_below_its_width():
    """T = 2 < d_conv - 1 = 3: the tail keeps d_conv - 1 rows, zeros
    first, as the reference's."""
    (rout, rst), (tout, tst) = _scan_pair("mamba", 2, "float32")
    assert tuple(tst["conv"].shape) == tuple(rst["conv"].shape) == (B, 3, tst["conv"].shape[-1])
    assert not bool(tst["conv"][:, 0].any()) and bool(tst["conv"][:, 1:].all())
    _close(rst["conv"], tst["conv"], **F32)
    _close(rout, tout, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(MODULES))
def test_decode_steps_from_the_scan_states(name, dtype):
    """Three decode steps from the reference's scan states (carried
    across), against the reference's steps: outputs and every state."""
    arch, _, _, rstep, _, tstep = MODULES[name]
    rp, tp = _module_params(name)
    (_, rst), _ = _scan_pair(name, 34, dtype)
    step = _jit(rstep, _cfg(arch, dtype))
    tst = {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in rst.items()}
    rjp = jax.tree.map(jnp.asarray, rp)
    xs = np.random.default_rng(40).normal(size=(GEN, B, 1, _cfg(arch).d_model)).astype(np.float32)
    for x in xs:
        carried = {k: torch.tensor(np.asarray(v, np.float32)).to(tst[k].dtype) for k, v in rst.items()}
        rout, rst = step(rjp, jnp.asarray(x).astype(dtype), rst)
        tout, tst = tstep(tp, torch.tensor(x).to(getattr(torch, dtype)), tst, _tcfg(arch, dtype))
        cout, _ = tstep(tp, torch.tensor(x).to(getattr(torch, dtype)), carried, _tcfg(arch, dtype))
        assert tuple(tout.shape) == (B, 1, _cfg(arch).d_model)
        _close(rout, tout, **_tol(dtype, rout))
        _close(rout, cout, **_tol(dtype, rout))
        for key, r in rst.items():
            assert str(tst[key].dtype).removeprefix("torch.") == str(r.dtype), key
            _close(r, tst[key], **_tol(dtype, r))


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_block_with_lora_against_the_reference(dtype, cached):
    """Zamba2's shared block at invocation 1 with its nonzero LoRA row,
    without and with a KV cache (prefill of 12 tokens at slot 0, written
    in place): output and cache.  The LoRA term is larger than the
    tolerance, so a fault in it would show."""
    rm, tm = _pair(ZAMBA, dtype)
    rp = _ref_params(ZAMBA)[0]
    tp = tm.params()
    t = 12
    x = np.random.default_rng(41).normal(size=(B, t, rm.cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (B, t))
    rcache = tcache = None
    if cached:
        rcache = jax.tree.map(lambda c: c[1], rm.init_cache(B, t + 4)["shared"])
        tcache = tcm.map_tree(lambda _, c: c[1], tm.init_cache(B, t + 4)["shared"])
    fn = jax.jit(lambda s, lo, x, c: rhy._shared_block(rm.cfg, s, lo, 1, x, jnp.asarray(pos), c))
    rout, rnew = fn(rp["shared"], rp["lora"], jnp.asarray(x).astype(dtype), rcache)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    tout, tnew = thy._shared_block(tm.cfg, tp["shared"], tp["lora"], 1, tx, torch.tensor(pos), tcache)
    tol = _tol(dtype, rout)
    _close(rout, tout, **tol)
    if cached:
        _caches_close(rnew, tnew, CACHE if dtype == "float32" else dict(rtol=2.0**-7, atol=bf16_tol(_np(rnew["k"]))))
        assert int(tnew["idx"]) == t
    else:
        assert rnew is None and tnew is None
    no_lora = dict(tp["lora"], b_q=torch.zeros_like(tp["lora"]["b_q"]))
    bare, _ = thy._shared_block(tm.cfg, tp["shared"], no_lora, 1, tx, torch.tensor(pos), None)
    assert float((bare - tout).abs().max()) > 2 * tol["atol"]


# ----------------------------------------------------------------------
# parameters and caches
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_and_stored_dtypes(arch):
    """The reference's names and shapes; at the config's bfloat16
    compute the reference's float32-cast leaves and ``lm_head`` stay
    float32, every other weight is bfloat16; ``hidden_step`` and
    ``head_matrix`` are None, as the reference's."""
    tm = tbuild(tconfigs.reduced(tconfigs.get_config(arch)), device="cpu")
    ref = _ref_params(arch)[1]
    sd = tm.state_dict()
    assert {n: tuple(p.shape) for n, p in sd.items()} == {n: tuple(x.shape) for n, x in tcm.iter_leaves(ref)}
    f32 = {n for n in sd if n == "lm_head" or n.rsplit(".", 1)[-1] in tlm.FLOAT32_LEAVES}
    assert {n for n, v in sd.items() if v.dtype == torch.float32} == f32
    assert all(v.dtype == torch.bfloat16 for n, v in sd.items() if n not in f32)
    assert f32 - {"lm_head"}  # each family has float32-cast leaves
    assert isinstance(tm, treg.RecurrentModel)
    assert tm.hidden_step is None and tm.head_matrix is None
    rm = rbuild(reduced(get_config(arch)))
    assert rm.hidden_step is None and rm.head_matrix is None


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_equals_the_reference(arch):
    """Every leaf's shape, dtype and value, -1e30 in each ``m``."""
    rm, tm = _pair(arch)
    rc, tc = rm.init_cache(B, 10), tm.init_cache(B, 10)
    ref = dict(tcm.iter_leaves(jax.tree.map(np.asarray, rc)))
    port = dict(tcm.iter_leaves(tc))
    assert sorted(ref) == sorted(port)
    for name, x in ref.items():
        assert (tuple(port[name].shape), str(port[name].dtype).removeprefix("torch.")) == (
            x.shape, str(x.dtype)), name
        np.testing.assert_array_equal(_np(port[name]), _np(x), err_msg=name)
    ms = [n for n in port if n.endswith(".m")]
    assert ms == ([] if arch == ZAMBA else ["mlstm.m", "slstm.m"])
    for name in ms:
        assert bool((port[name] == torch.tensor(-1e30, dtype=torch.float32)).all())
    abstract = dict(tcm.iter_leaves(treg.cache_abstract(tm.cfg, B, 10)))
    assert {n: (s.shape, s.dtype) for n, s in abstract.items()} == {
        n: (tuple(v.shape), v.dtype) for n, v in port.items()}


# ----------------------------------------------------------------------
# the models
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_against_the_reference(arch):
    rm, tm = _pair(arch)
    batch = {"tokens": _prompts(rm.cfg, seed=2)}
    ref = jax.jit(rm.forward)(_ref_params(arch)[0], batch)
    port = tm(batch)
    assert tuple(port.shape) == (B, T, tm.cfg.padded_vocab)
    _close(ref, port, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_steps_with_every_cache_leaf(arch):
    """Prefill over 34 tokens (17 mLSTM chunks of 2, 17 Mamba2 chunks of
    2), then greedy decode steps: logits and every cache leaf after each,
    the caller's caches left as they were; each step also runs from the
    reference's caches carried across.  The last logits of the prefill
    over T + 1 tokens equal those of the prefill over T and one step."""
    rm, tm = _pair(arch)
    params = _ref_params(arch)[0]
    prompts = _prompts(rm.cfg, seed=3, t=T + 1)
    max_len = T + GEN + 1
    rl, rc = jax.jit(rm.prefill)(params, {"tokens": prompts[:, :T]}, rm.init_cache(B, max_len))
    tc0 = tm.init_cache(B, max_len)
    before = tcm.map_tree(lambda _, c: c.clone(), tc0)
    tl, tc = tm.prefill({"tokens": prompts[:, :T]}, tc0)
    for (_, a), (_, b) in zip(tcm.iter_leaves(tc0), tcm.iter_leaves(before)):
        assert torch.equal(a, b)
    assert tuple(tl.shape) == (B, 1, tm.cfg.padded_vocab)
    _close(rl, tl, **F32)
    _caches_close(rc, tc)
    if arch == ZAMBA:
        assert tc["shared"]["idx"].tolist() == [T] * 2
    step = jax.jit(rm.decode_step)
    tok = prompts[:, T]
    for i in range(GEN):
        pos = np.full((B, 1), T + i, np.int32)
        carried = convert.decoder_cache_from_reference(tm.cfg, jax.tree.map(np.asarray, rc))
        held = tcm.map_tree(lambda _, c: c.clone(), tc)
        rl, rc = step(params, tok[:, None], rc, pos)
        tl2, tc2 = tm.decode_step(tok[:, None], tc, pos)
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tcm.iter_leaves(tc), tcm.iter_leaves(held)))
        tl, tc = tl2, tc2
        _close(rl, tl, **F32)
        _caches_close(rc, tc)
        cl, cc = tm.decode_step(tok[:, None], carried, pos)
        _close(rl, cl, **F32)
        # a bfloat16 leaf written by the step rounds a float32 value that
        # can sit a few ulps from a rounding boundary, one way or the other
        # by the CPU's summation order: one bfloat16 ulp (CACHE), as the
        # leaves of the steps above; every float32 leaf stays at F32
        _caches_close(rc, cc, F32, bf16=CACHE)
        if i == 0:  # prefill over T + 1 tokens == prefill over T, then this step
            whole, _ = tm.prefill({"tokens": prompts}, tm.init_cache(B, max_len))
            _close(tl, whole, **F32)
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
        np.testing.assert_array_equal(tserve.argmax_last(tl, tm.cfg.vocab_size), tok)


def test_carried_step_cache_check_fails_on_one_perturbed_weight():
    """The carried step's cache check above (bfloat16 leaves within
    ``CACHE``, float32 leaves within ``F32``) catches a real fault: one
    entry of the first Mamba2 layer's ``d_skip`` moved by 1e-3 in the port."""
    rm, tm = _pair(ZAMBA)
    params = _ref_params(ZAMBA)[0]
    prompts = _prompts(rm.cfg, seed=3, t=T + 1)
    max_len = T + GEN + 1
    _, rc = jax.jit(rm.prefill)(params, {"tokens": prompts[:, :T]}, rm.init_cache(B, max_len))
    carried = convert.decoder_cache_from_reference(tm.cfg, jax.tree.map(np.asarray, rc))
    pos = np.full((B, 1), T, np.int32)
    _, rc = jax.jit(rm.decode_step)(params, prompts[:, T:], rc, pos)
    _, cc = tm.decode_step(prompts[:, T:], carried, pos)
    _caches_close(rc, cc, F32, bf16=CACHE)
    with torch.no_grad():
        tm.get_parameter("mamba.core.d_skip").view(-1)[0] += 1e-3
    _, cc = tm.decode_step(prompts[:, T:], carried, pos)
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        _caches_close(rc, cc, F32, bf16=CACHE)


@pytest.mark.parametrize("arch", ARCHS)
def test_converters_refuse_foreign_recurrent_trees(arch):
    cfg, ref = _tcfg(arch), _ref_params(arch)[1]
    group = "slstm" if arch == XLSTM else "mamba"
    core = dict(ref[group]["core"])
    leaf = sorted(core)[0]
    del core[leaf]
    with pytest.raises(ValueError, match=f"missing.*{group}.core.{leaf}"):
        convert.decoder_params_from_reference(cfg, dict(ref, **{group: dict(ref[group], core=core)}))
    if arch == XLSTM:  # an mLSTM stack without its [G, k-1] nesting
        flat = tcm.map_tree(lambda _, a: a[:, 0], ref["mlstm"])
        with pytest.raises(ValueError, match=r"mlstm\.core\.\w+ has shape \(2, 8\), want \(2, 1, 8\)"):
            convert.decoder_params_from_reference(cfg, dict(ref, mlstm=flat))
    else:  # one LoRA row short
        lora = dict(ref["lora"], b_q=ref["lora"]["b_q"][:1])
        with pytest.raises(ValueError, match="lora.b_q has shape"):
            convert.decoder_params_from_reference(cfg, dict(ref, lora=lora))
    other = XLSTM if arch == ZAMBA else ZAMBA
    with pytest.raises(ValueError, match="unknown"):
        convert.decoder_params_from_reference(cfg, _ref_params(other)[1])
    caches = jax.tree.map(np.asarray, rbuild(_cfg(arch)).init_cache(B, 6))
    with pytest.raises(ValueError, match="no stacked"):  # the other family's caches
        convert.decoder_cache_from_reference(cfg, jax.tree.map(np.asarray, rbuild(_cfg(other)).init_cache(B, 6)))
    bad = dict(caches, extra=caches[group])
    with pytest.raises(ValueError, match="unknown.*extra"):
        convert.decoder_cache_from_reference(cfg, bad)
    sub = "mlstm" if arch == XLSTM else "mamba"
    short = dict(caches, **{sub: {k: v for k, v in caches[sub].items() if k != sorted(caches[sub])[0]}})
    with pytest.raises(ValueError, match=f"missing.*{sub}.{sorted(caches[sub])[0]}"):
        convert.decoder_cache_from_reference(cfg, short)
    if arch == ZAMBA:
        cut = dict(caches, mamba=dict(caches["mamba"], state=caches["mamba"]["state"][:2]))
        with pytest.raises(ValueError, match="mamba.state has shape"):
            convert.decoder_cache_from_reference(cfg, cut)


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_greedy_decode_gives_the_reference_tokens(arch, monkeypatch, capsys):
    """The port's launcher in process on the reduced model at float32
    compute, on the reference's weights: its prompts (``default_rng(0)``)
    through prefill and greedy decode give the tokens the reference's
    model gives through the reference launcher's loop."""
    rm, tm = _pair(arch)
    tokens = []
    monkeypatch.setattr(tserve, "reduce_cfg", lambda cfg: tm.cfg)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, seed, device: tm)
    argmax = tserve.argmax_last
    monkeypatch.setattr(tserve, "argmax_last",
                        lambda logits, vocab: tokens.append(argmax(logits, vocab)) or tokens[-1])
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "20", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert f"serving {arch} on cpu" in out
    assert "prefill:" in out and "for 20 x 2 tokens" in out and "ms/step (batch 2)" in out

    params = _ref_params(arch)[0]
    prompts = np.random.default_rng(0).integers(0, rm.cfg.vocab_size, (2, 20)).astype(np.int32)
    logits, cache = jax.jit(rm.prefill)(params, {"tokens": prompts}, rm.init_cache(2, 24))
    want = [np.asarray(rserve.jnp_argmax(logits, rm.cfg.vocab_size))]
    step = jax.jit(rm.decode_step)
    for i in range(3):
        logits, cache = step(params, want[-1][:, None], cache, np.full((2, 1), 20 + i, np.int32))
        want.append(np.asarray(rserve.jnp_argmax(logits, rm.cfg.vocab_size)))
    assert len(tokens) == len(want) == 4
    for t, w in zip(tokens, want):
        np.testing.assert_array_equal(t, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_private_head_refused_as_the_reference_after_the_prefill(arch, monkeypatch, capsys):
    rm = rbuild(_cfg(arch))
    args = argparse.Namespace(batch=2, prompt_len=8, gen_len=4, workers=16)
    with pytest.raises(SystemExit) as ref:
        rserve._decode_private_head(args, rm.cfg, rm, None, None, None)
    prefills = []
    prefill = treg.RecurrentModel.prefill
    monkeypatch.setattr(treg.RecurrentModel, "prefill",
                        lambda self, b, c: prefills.append(1) or prefill(self, b, c))
    with pytest.raises(SystemExit) as port:
        tserve.main(["--arch", arch, "--reduced", "--private-head", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert str(port.value) == str(ref.value)
    assert f"family {rm.cfg.family!r} does not expose one" in str(port.value)
    assert prefills == [1]
    assert f"serving {arch} on cpu" in capsys.readouterr().out
