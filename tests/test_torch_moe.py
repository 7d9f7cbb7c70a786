"""The port's MoE and MLA against the JAX package's, on the same inputs.

The reference models are ``reduced(deepseek-v2-lite-16b)`` (MLA
attention, a dense first layer, 4 experts top-2 plus 2 shared) and
``reduced(dbrx-132b)`` (GQA, 4 experts top-2), with float32 compute,
initialised with ``jax.random.PRNGKey(0)``; their parameters carry into
the port through ``convert.decoder_params_from_reference`` and their
caches through ``convert.decoder_cache_from_reference``.  Inputs come
from numpy with fixed seeds; the port runs on the CPU.

Tolerances are those of ``tests/test_torch_models.py``, for the same
reasons: float32 (``F32``) one rounding per operation in another order,
and K/V (here c and k_rope) read back through the bfloat16 cache, where
an input that differs in its last float32 bit can round to the
neighbouring bfloat16 value (observed: 2e-4 on DeepSeek's logits of
magnitude ~4); bfloat16 compute (``bf16_tol``) 4 bfloat16 ulps of the
largest value.  Cache entries (``CACHE``): one bfloat16 ulp (2**-7
relative) by that rounding, plus ``F32``'s absolute 2e-4 for entries of
a later layer, whose float32 inputs carry the drift of an earlier
layer's flipped rounding (observed: 2.3e-5 on an entry of 0.0019, three
of its ulps).  Expert choices
and capacity drops are discrete and compared exactly: the port's
``route`` against ``jax.lax.top_k`` on the same probabilities, its
``dispatch`` against a loop over the pairs.
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
from repro.models import attention as rat
from repro.models import build_model as rbuild
from repro.models import common as rcm
from repro.models import ffn as rffn
from repro.models import lm as rlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tat
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tcm
from repro_torch.models import ffn as tffn
from repro_torch.models import lm as tlm
from test_torch_models import F32, _close, _np, bf16_tol

ARCHS = ("deepseek-v2-lite-16b", "dbrx-132b")
CACHE = dict(rtol=2.0**-7, atol=2e-4)
B, T, GEN = 2, 8, 3


def _cfg(arch, dtype="float32", **moe):
    cfg = dataclasses.replace(reduced(get_config(arch)), compute_dtype=dtype)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg


def _tcfg(arch, dtype="float32", **moe):
    cfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), compute_dtype=dtype)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg


_PARAMS = {}


def _ref_params(arch):
    """(jax params, numpy params) of the reduced ``arch``, made once."""
    if arch not in _PARAMS:
        params = rbuild(_cfg(arch)).init(jax.random.PRNGKey(0))
        _PARAMS[arch] = params, jax.tree.map(np.asarray, params)
    return _PARAMS[arch]


def _pair(arch, dtype="float32"):
    tm = tbuild(_tcfg(arch, dtype), device="cpu")
    tm.load_state_dict(convert.decoder_params_from_reference(tm.cfg, _ref_params(arch)[1]))
    return rbuild(_cfg(arch, dtype)), tm


def _prompts(cfg, seed=1, b=B, t=T):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _moe_layer(arch, layer=0):
    return {k: (v[layer] if k != "shared" else {s: w[layer] for s, w in v.items()})
            for k, v in _ref_params(arch)[1]["layers"]["moe"].items()}


def _tensors(tree):
    return tcm.map_tree(lambda _, a: torch.tensor(np.asarray(a)), tree)


def _kept(eidx: np.ndarray, e: int, cap: int) -> np.ndarray:
    """The reference's keep rule as a loop: within each group, pairs in
    order of expert id (ties by position), each kept while its expert has
    taken fewer than ``cap``; returned in the sorted order."""
    out = []
    for flat in eidx.reshape(eidx.shape[0], -1):
        taken = np.zeros(e, int)
        keep = []
        for q in np.argsort(flat, kind="stable"):
            keep.append(taken[flat[q]] < cap)
            taken[flat[q]] += 1
        out.append(keep)
    return np.array(out)


def _moe_pair(arch, p, x, dtype="float32", **moe):
    rcfg, tcfg = _cfg(arch, dtype, **moe), _tcfg(arch, dtype, **moe)
    jdt = getattr(jnp, dtype)
    ref = jax.jit(rffn.moe_ffn, static_argnums=2)(jax.tree.map(jnp.asarray, p), jnp.asarray(x, jdt),
                                                  rcfg)
    port = tffn.moe_ffn(_tensors(p), torch.tensor(x).to(getattr(torch, dtype)), tcfg)
    return ref, port, tcfg


def _routes(p, x, tcfg):
    """The port's (probs, expert ids) of ``moe_ffn``'s router on x."""
    g, ng, _ = tffn.dispatch_shape(tcfg, x.shape[0] * x.shape[1])
    logits = (torch.tensor(x).reshape(g, ng, -1) @ torch.tensor(p["router"])).float()
    probs, _, eidx = tffn.route(logits, tcfg.moe.num_experts_per_tok)
    return probs, eidx


def _same_choices_as_the_reference(probs, eidx, k):
    _, ref_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(ref_idx))


# ----------------------------------------------------------------------
# moe_ffn
# ----------------------------------------------------------------------
# (B, T): n = 4, 6 and 16 tokens are 4, 6 and 16 groups of one token
# under dispatch_groups = 16; n = 20 is 10 groups of 2, n = 48 16 of 3
MOE_SHAPES = [(1, 4), (2, 3), (2, 8), (4, 5), (2, 24)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bt", MOE_SHAPES, ids=lambda bt: f"n{bt[0] * bt[1]}")
def test_moe_ffn_at_float32(arch, bt):
    p = _moe_layer(arch)
    x = np.random.default_rng(10).normal(size=(*bt, 64)).astype(np.float32)
    (rout, raux), (tout, taux), tcfg = _moe_pair(arch, p, x)
    assert taux.dtype == torch.float32 and tuple(tout.shape) == x.shape
    _close(rout, tout, **F32)
    _close(raux, taux, rtol=1e-5, atol=1e-7)
    _same_choices_as_the_reference(*_routes(p, x, tcfg), tcfg.moe.num_experts_per_tok)


@pytest.mark.parametrize("groups", [16, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_drops_pairs_past_capacity_as_the_reference(arch, groups):
    """capacity_factor 1.25 (the full configs' value; the reduced ones are
    dropless at 8.0): 48 tokens in 16 groups of 3 (capacity 1) or 4 groups
    of 12 (capacity 7).  Pairs are really dropped, on the same pairs, and
    the outputs agree."""
    p = _moe_layer(arch)
    x = np.random.default_rng(11).normal(size=(2, 24, 64)).astype(np.float32)
    moe = dict(capacity_factor=1.25, dispatch_groups=groups)
    (rout, raux), (tout, taux), tcfg = _moe_pair(arch, p, x, **moe)
    g, ng, cap = tffn.dispatch_shape(tcfg, 48)
    assert (g, ng, cap) == ((16, 3, 1) if groups == 16 else (4, 12, 7))
    probs, eidx = _routes(p, x, tcfg)
    _same_choices_as_the_reference(probs, eidx, tcfg.moe.num_experts_per_tok)
    _, _, keep, _, _ = tffn.dispatch(eidx, tcfg.moe.num_experts, cap)
    want = _kept(eidx.numpy(), tcfg.moe.num_experts, cap)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert not want.all()
    _close(rout, tout, **F32)
    _close(raux, taux, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("router", ["two zero columns", "all zero"])
def test_moe_ffn_breaks_router_ties_as_the_reference(router):
    """Router columns 1 and 2 zero: their logits are exactly 0, so they tie
    for every token, and the lower id must come first, as jax.lax.top_k
    puts it.  All zero: every expert ties, every token takes experts 0
    and 1, and at capacity_factor 1.25 most pairs are dropped."""
    arch = "deepseek-v2-lite-16b"
    p = _moe_layer(arch)
    p["router"] = p["router"].copy()
    p["router"][:, 1:3] = 0.0
    if router == "all zero":
        p["router"][:] = 0.0
    x = np.random.default_rng(12).normal(size=(2, 8, 64)).astype(np.float32)
    (rout, _), (tout, _), tcfg = _moe_pair(arch, p, x, capacity_factor=1.25, dispatch_groups=2)
    probs, eidx = _routes(p, x, tcfg)
    assert torch.equal(probs[..., 1], probs[..., 2])
    _same_choices_as_the_reference(probs, eidx, 2)
    if router == "all zero":
        assert bool((eidx == torch.tensor([0, 1])).all())
    else:  # some tokens rank both zero-logit experts first
        assert bool((eidx == torch.tensor([1, 2])).all(-1).any())
    _close(rout, tout, **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_at_bfloat16_within_its_tolerance(arch):
    p = _moe_layer(arch, layer=1)
    x = np.random.default_rng(13).normal(size=(2, 8, 64)).astype(np.float32)
    (rout, raux), (tout, taux), _ = _moe_pair(arch, p, x, dtype="bfloat16")
    assert tout.dtype == torch.bfloat16 and taux.dtype == torch.float32
    _close(rout, tout, rtol=0, atol=bf16_tol(_np(rout)))
    _close(raux, taux, rtol=2.0**-7, atol=0)


# ----------------------------------------------------------------------
# mla_attention
# ----------------------------------------------------------------------
def _mla_layer(layer):
    return {k: v[layer] for k, v in _ref_params(ARCHS[0])[1]["layers"]["attn"].items()}


def test_mla_attention_without_cache():
    cfg = _cfg(ARCHS[0])
    p = _mla_layer(1)
    x = np.random.default_rng(14).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    ref, _ = jax.jit(rat.mla_attention, static_argnums=3)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos), cfg)
    port, cache = tat.mla_attention(_tensors(p), torch.tensor(x), torch.tensor(pos), _tcfg(ARCHS[0]))
    assert cache is None
    _close(ref, port, **F32)


def test_mla_attention_with_cache():
    """A prompt written at idx 0, then one token at idx T: outputs, the
    compressed c / k_rope buffers and write positions."""
    cfg, tcfg = _cfg(ARCHS[0]), _tcfg(ARCHS[0])
    p = _mla_layer(0)
    tp = _tensors(p)
    rng = np.random.default_rng(15)
    rc = {k: jnp.zeros(s.shape, s.dtype) for k, s in rat.mla_cache_spec(cfg, B, T + 2).items()}
    tc = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in tat.mla_cache_spec(tcfg, B, T + 2).items()}
    assert {k: tuple(v.shape) for k, v in tc.items()} == {k: v.shape for k, v in rc.items()}
    assert tc["c"].dtype == tc["k_rope"].dtype == torch.bfloat16 and tc["idx"].dtype == torch.int32
    for t0, n in ((0, T), (T, 1)):
        x = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(t0, t0 + n), (B, n)).astype(np.int32)
        ref, rc = jax.jit(rat.mla_attention, static_argnums=3)(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos), cfg, cache=rc)
        port, tc = tat.mla_attention(tp, torch.tensor(x), torch.tensor(pos), tcfg, cache=tc)
        _close(ref, port, **F32)
        _close(rc["c"], tc["c"], **CACHE)
        _close(rc["k_rope"], tc["k_rope"], **CACHE)
        assert int(tc["idx"]) == int(rc["idx"]) == t0 + n


# ----------------------------------------------------------------------
# the whole model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_tree_names_and_dtypes_match_the_reference(arch):
    rcfg = reduced(get_config(arch))
    tm = tbuild(tconfigs.reduced(tconfigs.get_config(arch)), device="cpu")  # bfloat16 compute
    ref_shapes = {n: tuple(x.shape) for n, x in tcm.iter_leaves(_ref_params(arch)[1])}
    assert {n: tuple(p.shape) for n, p in tm.state_dict().items()} == ref_shapes
    assert tcm.count_params(tm.abstract_params()) == rcm.count_params(rlm.decoder_abstract(rcfg))
    assert ("dense_layer_0.attn.w_dkv" in ref_shapes) == (arch == ARCHS[0])
    assert "layers.moe.router" in ref_shapes
    sd = tm.state_dict()
    assert sd["lm_head"].dtype == torch.float32
    assert all(v.dtype == torch.bfloat16 for k, v in sd.items() if k != "lm_head")


def _caches_close(rc, tc):
    assert sorted(rc) == sorted(tc)
    for name, r in tcm.iter_leaves(rc):
        t = dict(tcm.iter_leaves(tc))[name]
        if name.endswith("idx"):
            np.testing.assert_array_equal(np.asarray(r), t.numpy())
        else:
            _close(r, t, **CACHE)


def _f32_caches(tree):
    """A cache tree (the reference's or the port's) with every float leaf
    in float32: the prefill and the steps then write and read float32
    K/V, so no bfloat16 rounding boundary sits inside a float32
    comparison."""
    if isinstance(next(iter(tcm.iter_leaves(tree)))[1], torch.Tensor):
        return tcm.map_tree(lambda _, a: a.float() if a.is_floating_point() else a, tree)
    return jax.tree.map(lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def _bf16_valued(tree):
    """The reference's float32 caches rounded to bfloat16 values (kept in
    float32): what ``convert.decoder_cache_from_reference`` carries
    exactly into the port's bfloat16 buffers."""
    return jax.tree.map(
        lambda a: a.astype(jnp.bfloat16).astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        tree)


def _prefill_decode_and_hidden_step(rm, tm, params, arch, bf16_caches=False):
    """Prefill, ``GEN`` greedy decode steps, ``hidden_step``, then the
    same step from the reference's caches carried into the port's
    bfloat16 buffers; logits (or hidden states) and every cache leaf
    after each.  With float32 caches (``_f32_caches``) the logits are
    held to ``F32``.  With the models' own bfloat16 caches a K/V entry
    within a float32 ulp of a bfloat16 rounding boundary may round either
    way, depending on the CPU's summation order: the caches are held to
    ``CACHE`` (one bfloat16 ulp) and the logits to one bfloat16 ulp of
    the largest (``_bf16_logits``), which such a flip stays far inside
    (it moved a logit by 2.8e-4 of a largest 3.77)."""
    prompts = _prompts(tm.cfg)
    if bf16_caches:
        rc, tc = rm.init_cache(B, T + GEN + 1), tm.init_cache(B, T + GEN + 1)
        close = _bf16_logits
    else:
        rc, tc = (_f32_caches(m.init_cache(B, T + GEN + 1)) for m in (rm, tm))
        close = lambda r, t: _close(r, t, **F32)  # noqa: E731
    rl, rc = jax.jit(rm.prefill)(params, {"tokens": prompts}, rc)
    tl, tc = tm.prefill({"tokens": prompts}, tc)
    assert tuple(tl.shape) == (B, 1, tm.cfg.padded_vocab)
    close(rl, tl)
    _caches_close(rc, tc)
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    step = jax.jit(rm.decode_step)
    for i in range(GEN):
        pos = np.full((B, 1), T + i, np.int32)
        rl, rc = step(params, tok[:, None], rc, pos)
        tl, tc = tm.decode_step(tok[:, None], tc, pos)
        close(rl, tl)
        _caches_close(rc, tc)
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    pos = np.full((B, 1), T + GEN, np.int32)
    hidden = jax.jit(rm.hidden_step)
    rh, rc2 = hidden(params, tok[:, None], rc, pos)
    th, tc2 = tm.hidden_step(tok[:, None], tc, pos)
    close(rh, th)
    _caches_close(rc2, tc2)
    # the same step from the reference's caches carried into the port's
    # bfloat16 buffers (values a bfloat16 holds, so the carry is exact)
    rc_b = rc if bf16_caches else _bf16_valued(rc)
    carried = convert.decoder_cache_from_reference(tm.cfg, jax.tree.map(np.asarray, rc_b))
    assert all(c.dtype == torch.bfloat16 for n, c in tcm.iter_leaves(carried) if not n.endswith("idx"))
    if not bf16_caches:
        carried = _f32_caches(carried)
    _caches_close(rc_b, carried)
    rh, _ = hidden(params, tok[:, None], rc_b, pos)
    th, _ = tm.hidden_step(tok[:, None], carried, pos)
    close(rh, th)
    np.testing.assert_array_equal(np.asarray(rm.head_matrix(params)), tm.head_matrix().numpy())


def _bf16_logits(ref, port):
    """Within one bfloat16 ulp (2**-7) of the reference's largest value."""
    _close(ref, port, rtol=0, atol=2.0**-7 * float(np.abs(_np(ref)).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_hidden_step_at_float32(arch):
    """At float32 compute: once with float32 caches in both packages
    (logits to ``F32``), once with the models' own bfloat16 caches (the
    caches to one bfloat16 ulp, the logits to one bfloat16 ulp of the
    largest); see ``_prefill_decode_and_hidden_step``."""
    rm, tm = _pair(arch)
    for bf16_caches in (False, True):
        _prefill_decode_and_hidden_step(rm, tm, _ref_params(arch)[0], arch, bf16_caches)


@pytest.mark.parametrize("caches", ["float32", "bfloat16"])
def test_float32_check_fails_on_one_perturbed_weight(caches):
    """Each run of the check above catches a real fault: one entry of
    DeepSeek's ``w_dkv`` moved by 1e-3 in the port only.  (With bfloat16
    caches the cache check fails: the entries it feeds move by ~100
    bfloat16 ulps, where the logits move by ~3e-3 and so stay within one
    bfloat16 ulp of the largest.)"""
    arch = ARCHS[0]
    rm, tm = _pair(arch)
    with torch.no_grad():
        tm.get_parameter("layers.attn.w_dkv").view(-1)[7] += 1e-3
    with pytest.raises(AssertionError, match="Not equal to tolerance"):
        _prefill_decode_and_hidden_step(rm, tm, _ref_params(arch)[0], arch, caches == "bfloat16")


def test_steps_leave_the_callers_dense_prologue_cache_as_it_was():
    tm = tbuild(_tcfg(ARCHS[0]), device="cpu")
    cache = tm.init_cache(B, T + 1)
    assert sorted(cache) == ["dense_0", "layers"]
    _, filled = tm.prefill({"tokens": _prompts(tm.cfg)}, cache)
    assert not bool(cache["dense_0"]["c"].any()) and int(cache["dense_0"]["idx"]) == 0
    assert int(filled["dense_0"]["idx"]) == T and bool(filled["dense_0"]["c"][:, :T].ne(0).any())


def test_bfloat16_model_within_its_tolerance():
    """DeepSeek at its own compute dtype: the final-normed hidden states
    of a forward, bfloat16 in both packages."""
    arch = ARCHS[0]
    rm, tm = _pair(arch, "bfloat16")
    params = _ref_params(arch)[0]
    prompts = _prompts(tm.cfg, seed=8)
    rh = jax.jit(lambda p, b: rlm.decoder_forward(rm.cfg, p, b, head_mode="none")[0])(
        params, {"tokens": prompts})
    th = tlm.decoder_forward(tm.cfg, tm.params(), {"tokens": prompts}, head_mode="none")[0]
    assert th.dtype == torch.bfloat16
    _close(rh, th, rtol=0, atol=bf16_tol(_np(rh)))


def test_converters_refuse_foreign_moe_and_mla_trees():
    arch = ARCHS[0]
    cfg, ref = _tcfg(arch), _ref_params(arch)[1]
    bad = dict(ref, layers=dict(ref["layers"], moe={k: v for k, v in ref["layers"]["moe"].items()
                                                    if k != "router"}))
    with pytest.raises(ValueError, match="missing.*layers.moe.router"):
        convert.decoder_params_from_reference(cfg, bad)
    attn = dict(ref["dense_layer_0"]["attn"], w_dkv=np.zeros((64, 32), np.float32))
    with pytest.raises(ValueError, match="dense_layer_0.attn.w_dkv has shape"):
        convert.decoder_params_from_reference(cfg, dict(ref, dense_layer_0=dict(ref["dense_layer_0"],
                                                                                attn=attn)))
    with pytest.raises(ValueError, match="unknown.*dense_layer_0"):  # DBRX has no dense prologue
        convert.decoder_params_from_reference(_tcfg("dbrx-132b"), dict(_ref_params("dbrx-132b")[1],
                                                                        dense_layer_0=ref["dense_layer_0"]))
    caches = jax.tree.map(np.asarray, rbuild(_cfg(arch)).init_cache(B, 4))
    with pytest.raises(ValueError, match="no stacked layers.c"):  # GQA caches for an MLA model
        convert.decoder_cache_from_reference(
            cfg, jax.tree.map(np.asarray, rbuild(_cfg("dbrx-132b")).init_cache(B, 4)))
    with pytest.raises(ValueError, match="missing.*dense_0.c"):
        convert.decoder_cache_from_reference(cfg, {"layers": caches["layers"]})
    short = dict(caches, dense_0=dict(caches["dense_0"], k_rope=caches["dense_0"]["k_rope"][:, :2]))
    with pytest.raises(ValueError, match="dense_0.k_rope has shape"):
        convert.decoder_cache_from_reference(cfg, short)


# ----------------------------------------------------------------------
# the launcher's private head
# ----------------------------------------------------------------------
def test_private_head_decode_gives_the_reference_tokens_and_summary():
    """Both packages' ``_decode_private_head`` on reduced DeepSeek at
    float32 compute, on the reference's weights and the launchers' own
    prompts: the same greedy tokens and ``EngineReport.summary()``."""
    arch = ARCHS[0]
    args = argparse.Namespace(batch=2, prompt_len=8, gen_len=4, workers=16)
    rm, tm = _pair(arch)
    params = _ref_params(arch)[0]
    max_len = args.prompt_len + args.gen_len
    prompts = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (args.batch, args.prompt_len)).astype(np.int32)
    logits, cache = jax.jit(rm.prefill)(params, {"tokens": prompts}, rm.init_cache(args.batch, max_len))
    rtok = np.asarray(rserve.jnp_argmax(logits, tm.cfg.vocab_size))
    rsteps, rrep, _ = rserve._decode_private_head(args, rm.cfg, rm, params, cache, rtok)
    logits, cache = tm.prefill({"tokens": prompts}, tm.init_cache(args.batch, max_len))
    ttok = tserve.argmax_last(logits, tm.cfg.vocab_size)
    tsteps, trep, _ = tserve._decode_private_head(args, tm.cfg, tm, cache, ttok)
    np.testing.assert_array_equal(ttok, rtok)
    assert tsteps == rsteps == args.gen_len - 1
    assert trep.summary() == rrep.summary() and trep.summary()["served"] == tsteps
    for t, r in zip(trep.requests, rrep.requests):
        np.testing.assert_array_equal(t.y[: args.batch].argmax(-1), r.y[: args.batch].argmax(-1))


def test_launcher_serves_deepseek_with_a_private_head(capsys):
    tserve.main(["--arch", ARCHS[0], "--reduced", "--private-head", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert f"serving {ARCHS[0]} on cpu" in out
    assert "private head: 3 protocol replays over 3 steps on 16 workers" in out
