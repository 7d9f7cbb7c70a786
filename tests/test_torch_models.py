"""The port's dense decoder against the JAX package's, on the same inputs.

The reference model is ``reduced(get_config("mistral-nemo-12b"))``
initialised with ``jax.random.PRNGKey(0)``; its parameters carry into
the port through ``convert.decoder_params_from_reference`` and its
caches through ``convert.decoder_cache_from_reference``.  Inputs come
from numpy with fixed seeds; the port runs on the CPU.  The JAX side
needs no mesh: ``constrain`` does nothing without sharding rules.

Tolerances, each with its reason:

* float32 compute (``F32``): the two packages sum in other orders, about
  one float32 rounding (~6e-8 relative) per operation over four layers;
  the attention also reads K/V through the bfloat16 cache, where an
  input that differs in its last float32 bit can round to the
  neighbouring bfloat16 value.  Observed: 4e-5 on logits of magnitude 4.
* cache entries (``CACHE``): at most one bfloat16 ulp (2**-7 relative)
  apart, by that rounding.
* bfloat16 compute (``bf16_tol``): the frameworks round to bfloat16 at
  other points (products, SiLU, residual adds); 4 bfloat16 ulps of the
  largest value, 2**-5 * max|ref|.  Observed: ~2**-6.
* ``head_matrix``: exact (a copy times a scalar).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_config, reduced
from repro.models import attention as rat
from repro.models import build_model as rbuild
from repro.models import common as rcm
from repro.models import ffn as rffn
from repro.models import lm as rlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import attention as tat
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tcm
from repro_torch.models import ffn as tffn
from repro_torch.models import lm as tlm

ARCH = "mistral-nemo-12b"
F32 = dict(rtol=1e-4, atol=2e-4)
CACHE = dict(rtol=2.0**-7, atol=1e-6)
B, T, GEN = 2, 8, 3


def bf16_tol(ref) -> float:
    return 2.0**-5 * float(np.abs(ref).max())


def _np(x):
    """A reference or port value as a float32 (or integer) numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if np.issubdtype(x.dtype, np.floating) or x.dtype.kind == "V" else x


def _close(ref, port, **tol):
    np.testing.assert_allclose(_np(port), _np(ref), **tol)


def _cfg(dtype="float32"):
    return dataclasses.replace(reduced(get_config(ARCH)), compute_dtype=dtype)


def _tcfg(dtype="float32"):
    return dataclasses.replace(tconfigs.reduced(tconfigs.get_config(ARCH)), compute_dtype=dtype)


@pytest.fixture(scope="module")
def ref_params():
    cfg = _cfg()
    params = rbuild(cfg).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _pair(ref_params, dtype):
    """(reference Model, port Model) of ``dtype`` compute on one set of weights."""
    tm = tbuild(_tcfg(dtype), device="cpu")
    tm.load_state_dict(convert.decoder_params_from_reference(tm.cfg, ref_params[1]))
    return rbuild(_cfg(dtype)), tm


def _prompts(cfg, seed=1, b=B, t=T):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


# ----------------------------------------------------------------------
# configs and parameters
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_resolve_as_the_reference(arch):
    ref, port = get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(tconfigs.reduced(port)) == dataclasses.asdict(reduced(ref))
    assert port.param_count() == ref.param_count()
    assert port.padded_vocab == ref.padded_vocab


def test_parameter_tree_and_names_match_the_reference(ref_params):
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    tm = tbuild(cfg, device="cpu")
    ref_shapes = {n: tuple(x.shape) for n, x in tcm.iter_leaves(ref_params[1])}
    port_shapes = {n: tuple(p.shape) for n, p in tm.state_dict().items()}
    assert port_shapes == ref_shapes
    assert tcm.count_params(tm.abstract_params()) == rcm.count_params(
        rlm.decoder_abstract(reduced(get_config(ARCH))))
    assert tcm.count_params(tm.params()) == sum(x.size for _, x in tcm.iter_leaves(ref_params[1]))
    assert not any(p.requires_grad for p in tm.parameters())


def test_stored_dtypes_and_init_rules():
    cfg = tconfigs.reduced(tconfigs.get_config(ARCH))  # compute_dtype bfloat16
    tm = tbuild(cfg, seed=3, device="cpu")
    sd = tm.state_dict()
    assert sd["lm_head"].dtype == torch.float32
    assert all(v.dtype == torch.bfloat16 for k, v in sd.items() if k != "lm_head")
    assert torch.equal(sd["final_norm"].float(), torch.ones(cfg.d_model))
    assert torch.equal(sd["layers.ln_attn"].float(), torch.ones(cfg.num_layers, cfg.d_model))
    # embed: normal x 0.02; a matrix: normal / sqrt(fan_in), fan_in = shape[-2]
    assert abs(float(sd["embed"].float().std()) - 0.02) < 0.002
    assert abs(float(sd["lm_head"].std()) - cfg.d_model**-0.5) < 0.01
    assert abs(float(sd["layers.mlp.w_down"].float().std()) - cfg.d_ff**-0.5) < 0.01
    again = tbuild(cfg, seed=3, device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    f32 = tbuild(dataclasses.replace(cfg, compute_dtype="float32"), device="cpu")
    assert all(p.dtype == torch.float32 for p in f32.parameters())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_other_families_name_their_roadmap_item(arch):
    """Every family is ported (the ssm and hybrid families of ROADMAP
    item 12 last): the reduced model of each arch has the reference's
    parameter names and shapes, and each weight the dtype
    ``lm.stored_infos`` gives it."""
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    tm = tbuild(cfg, device="cpu")
    ref_infos = rbuild(reduced(get_config(arch))).abstract_params()
    ref_shapes = {n: tuple(i.shape) for n, i in tcm.iter_leaves(ref_infos)}
    sd = tm.state_dict()
    assert {n: tuple(p.shape) for n, p in sd.items()} == ref_shapes
    stored = dict(tcm.iter_leaves(tlm.stored_infos(cfg, tm.abstract_params())))
    assert {n: p.dtype for n, p in sd.items()} == {n: i.dtype for n, i in stored.items()}


def test_converters_refuse_foreign_trees(ref_params):
    cfg = _tcfg()
    bad = dict(ref_params[1])
    del bad["final_norm"]
    with pytest.raises(ValueError, match="missing.*final_norm"):
        convert.decoder_params_from_reference(cfg, bad)
    bad = dict(ref_params[1], lm_head=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="lm_head has shape"):
        convert.decoder_params_from_reference(cfg, bad)
    caches = jax.tree.map(np.asarray, rbuild(_cfg()).init_cache(B, 4))
    caches["layers"]["extra"] = caches["layers"]["idx"]
    with pytest.raises(ValueError, match="unknown.*extra"):
        convert.decoder_cache_from_reference(cfg, caches)


# ----------------------------------------------------------------------
# per module
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5)).astype(np.int32)
    jx, tx = jnp.asarray(x, dtype), torch.tensor(x).to(getattr(torch, dtype))
    tol = F32 if dtype == "float32" else dict(rtol=2.0**-7, atol=2.0**-7)
    _close(rcm.rms_norm(jx, w, 1e-5), tcm.rms_norm(tx, torch.tensor(w), 1e-5), **tol)
    _close(rcm.rope_freqs(16, 1e6), tcm.rope_freqs(16, 1e6), rtol=1e-6, atol=0)
    _close(rcm.apply_rope(jx, pos, 1e6), tcm.apply_rope(tx, torch.tensor(pos), 1e6), **tol)


def test_mlp():
    rng = np.random.default_rng(3)
    p = {k: rng.normal(size=s).astype(np.float32) / 8
         for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    _close(rffn.mlp(p, x), tffn.mlp({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x)),
           **F32)


# (q_positions, q_chunk, k_chunk) of _sdpa_chunked, on [2, 12, 4, 16]
# queries and 24 keys: causal from offset 12 and from 0 in 4 x 8 blocks,
# chunk targets that divide neither length (4 x 6 blocks), and one block
SDPA_CASES = {
    "causal": (np.arange(12, 24), 4, 8),
    "causal from 0": (np.arange(12), 4, 8),
    "uneven chunks": (np.arange(12, 24), 5, 7),
    "one block": (np.arange(12, 24), 512, 1024),
}


@pytest.mark.parametrize("case", SDPA_CASES)
def test_sdpa_chunked_against_naive_and_the_reference(case):
    qpos, qc, kc = SDPA_CASES[case]
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    ref = rat._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                            q_positions=jnp.asarray(qpos), q_chunk=qc, k_chunk=kc)
    port = tat._sdpa_chunked(torch.tensor(q), torch.tensor(k), torch.tensor(v), 0.25,
                             q_positions=torch.tensor(qpos), q_chunk=qc, k_chunk=kc)
    _close(ref, port, **F32)
    mask = np.arange(24)[None, None, :] <= qpos[None, :, None]
    naive = tat._sdpa_naive(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                            torch.tensor(mask), 0.25)
    _close(naive, port, **F32)
    _close(rat._sdpa_naive(q, k, v, mask, 0.25), naive, **F32)


@pytest.mark.parametrize("impl", ["chunked", "naive"])
def test_gqa_attention_without_cache(ref_params, impl):
    cfg = _cfg()
    p = {k: v[1] for k, v in ref_params[1]["layers"]["attn"].items()}
    x = np.random.default_rng(5).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    ref, _ = rat.gqa_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos), cfg,
                               impl=impl)
    port, cache = tat.gqa_attention({k: torch.tensor(v) for k, v in p.items()}, torch.tensor(x),
                                    torch.tensor(pos), _tcfg(), impl=impl)
    assert cache is None
    _close(ref, port, **F32)


def test_gqa_attention_with_cache(ref_params):
    """A prompt written at idx 0, then one token at idx T: outputs, K/V
    buffers and write positions."""
    cfg = _cfg()
    p = {k: v[0] for k, v in ref_params[1]["layers"]["attn"].items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    rng = np.random.default_rng(6)
    spec = rat.gqa_cache_spec(cfg, B, T + 2)
    rc = {k: jnp.zeros(s.shape, s.dtype) for k, s in spec.items()}
    tc = {k: torch.zeros(s.shape, dtype=s.dtype)
          for k, s in tat.gqa_cache_spec(_tcfg(), B, T + 2).items()}
    assert tc["k"].dtype == torch.bfloat16 and tc["idx"].dtype == torch.int32
    for t0, n in ((0, T), (T, 1)):
        x = rng.normal(size=(B, n, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(t0, t0 + n), (B, n)).astype(np.int32)
        ref, rc = rat.gqa_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos), cfg,
                                    cache=rc)
        port, tc = tat.gqa_attention(tp, torch.tensor(x), torch.tensor(pos), _tcfg(), cache=tc)
        _close(ref, port, **F32)
        _close(rc["k"], tc["k"], **CACHE)
        _close(rc["v"], tc["v"], **CACHE)
        assert int(tc["idx"]) == int(rc["idx"]) == t0 + n


# ----------------------------------------------------------------------
# the whole model
# ----------------------------------------------------------------------
def _caches_close(rc, tc):
    _close(rc["layers"]["k"], tc["layers"]["k"], **CACHE)
    _close(rc["layers"]["v"], tc["layers"]["v"], **CACHE)
    np.testing.assert_array_equal(np.asarray(rc["layers"]["idx"]), tc["layers"]["idx"].numpy())


def test_prefill_decode_and_hidden_step_at_float32(ref_params):
    rm, tm = _pair(ref_params, "float32")
    params = ref_params[0]
    prompts = _prompts(tm.cfg)
    rc, tc = rm.init_cache(B, T + GEN + 1), tm.init_cache(B, T + GEN + 1)
    assert {k: v.dtype for k, v in tc["layers"].items()} == {
        "k": torch.bfloat16, "v": torch.bfloat16, "idx": torch.int32}
    rl, rc = jax.jit(rm.prefill)(params, {"tokens": prompts}, rc)
    tl, tc = tm.prefill({"tokens": prompts}, tc)
    assert tuple(tl.shape) == (B, 1, tm.cfg.padded_vocab)
    _close(rl, tl, **F32)
    _caches_close(rc, tc)
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    step = jax.jit(rm.decode_step)
    for i in range(GEN):
        pos = np.full((B, 1), T + i, np.int32)
        rl, rc = step(params, tok[:, None], rc, pos)
        tl, tc = tm.decode_step(tok[:, None], tc, pos)
        _close(rl, tl, **F32)
        _caches_close(rc, tc)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), np.asarray(rl[:, -1].argmax(-1)))
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    pos = np.full((B, 1), T + GEN, np.int32)
    rh, rc2 = jax.jit(rm.hidden_step)(params, tok[:, None], rc, pos)
    th, tc2 = tm.hidden_step(tok[:, None], tc, pos)
    assert tuple(th.shape) == (B, 1, tm.cfg.d_model)
    _close(rh, th, **F32)
    _caches_close(rc2, tc2)
    # the same step from the reference's own caches, carried across
    carried = convert.decoder_cache_from_reference(tm.cfg, jax.tree.map(np.asarray, rc))
    _caches_close(rc, carried)
    th, _ = tm.hidden_step(tok[:, None], carried, pos)
    _close(rh, th, **F32)


def test_steps_leave_the_callers_cache_as_it_was():
    """Each step copies the stacked caches once and writes into the copy:
    the caches it was given keep their values."""
    tm = tbuild(_tcfg(), device="cpu")
    cache = tm.init_cache(B, T + 1)
    before = {k: v.clone() for k, v in cache["layers"].items()}
    _, filled = tm.prefill({"tokens": _prompts(tm.cfg)}, cache)
    assert all(torch.equal(cache["layers"][k], before[k]) for k in before)
    assert torch.equal(filled["layers"]["idx"], torch.full((tm.cfg.num_layers,), T, dtype=torch.int32))
    assert bool(filled["layers"]["k"][:, :, :T].ne(0).any())
    before = {k: v.clone() for k, v in filled["layers"].items()}
    _, stepped = tm.decode_step(np.zeros((B, 1), np.int32), filled, np.full((B, 1), T, np.int32))
    assert all(torch.equal(filled["layers"][k], before[k]) for k in before)
    assert int(stepped["layers"]["idx"][0]) == T + 1


def test_forward_logits_and_head_matrix(ref_params):
    rm, tm = _pair(ref_params, "float32")
    prompts = _prompts(tm.cfg, seed=7)
    _close(jax.jit(rm.forward)(ref_params[0], {"tokens": prompts}), tm({"tokens": prompts}), **F32)
    np.testing.assert_array_equal(np.asarray(rm.head_matrix(ref_params[0])),
                                  tm.head_matrix().numpy())


def test_bfloat16_compute_within_its_tolerance(ref_params):
    """At the config's own compute dtype the port keeps the trunk in
    bfloat16 and the reference casts its float32 weights before each
    use: the same numbers up to where each framework rounds."""
    rm, tm = _pair(ref_params, "bfloat16")
    params = ref_params[0]
    assert tm.embed.dtype == torch.bfloat16 and tm.lm_head.dtype == torch.float32
    prompts = _prompts(tm.cfg, seed=8)
    rh = rlm.decoder_forward(rm.cfg, params, {"tokens": prompts}, head_mode="none")[0]
    th = tlm.decoder_forward(tm.cfg, tm.params(), {"tokens": prompts}, head_mode="none")[0]
    assert th.dtype == torch.bfloat16
    _close(rh, th, rtol=0, atol=bf16_tol(_np(rh)))
    rc = rm.init_cache(B, T + 1)
    rl, rc = jax.jit(rm.prefill)(params, {"tokens": prompts}, rc)
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)[:, None]
    pos = np.full((B, 1), T, np.int32)
    rh, _ = jax.jit(rm.hidden_step)(params, tok, rc, pos)
    th, _ = tm.hidden_step(tok, convert.decoder_cache_from_reference(tm.cfg, jax.tree.map(np.asarray, rc)), pos)
    _close(rh, th, rtol=0, atol=bf16_tol(_np(rh)))
    np.testing.assert_array_equal(np.asarray(rm.head_matrix(params)), tm.head_matrix().numpy())
