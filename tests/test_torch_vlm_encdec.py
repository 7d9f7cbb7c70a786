"""The port's vlm and encoder-decoder models against the JAX package's,
on the same inputs.

The reference models are ``reduced(internvl2-26b)`` (the decoder trunk
with a prefix of 8 patch embeddings) and ``reduced(seamless-m4t-large-v2)``
(2 encoder and 2 decoder layers, the decoder's cross-attention to the
encoder's output), with float32 compute, initialised with
``jax.random.PRNGKey(0)``; their parameters carry into the port through
``convert.decoder_params_from_reference`` and their caches through
``convert.decoder_cache_from_reference``.  Inputs come from numpy with
fixed seeds; the port runs on the CPU.

Tolerances are those of ``tests/test_torch_models.py``, for the same
reasons: float32 (``F32``) one rounding per operation in another order;
cache entries (``CACHE``) one bfloat16 ulp (2**-7 relative), by which a
float32 input that differs in its last bit can round to the
neighbouring bfloat16 value, plus ``F32``'s absolute 2e-4 for entries of
a later layer, which carry an earlier layer's drift (as
``tests/test_torch_moe.py``).  The encoder-decoder's ``enc_out`` buffer
is such a bfloat16 cache.  Decode steps also run from the reference's
own caches carried across, where both packages read the same bfloat16
values and ``F32`` holds alone.  Shapes, dtypes, write positions,
greedy tokens, engine summaries and refusal messages are compared
exactly.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, SHAPES, get_config, reduced
from repro.launch import serve as rserve
from repro.models import attention as rat
from repro.models import build_model as rbuild
from repro.models import lm as rlm
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tat
from repro_torch.models import build_model as tbuild
from repro_torch.models import common as tcm
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from test_torch_models import F32, _close

VLM, ENCDEC = "internvl2-26b", "seamless-m4t-large-v2"
CACHE = dict(rtol=2.0**-7, atol=2e-4)
B, T, GEN, TE = 2, 8, 3, 12  # batch, decoder tokens, decode steps, encoder frames


def _cfg(arch, dtype="float32"):
    return dataclasses.replace(reduced(get_config(arch)), compute_dtype=dtype)


def _tcfg(arch, dtype="float32"):
    return dataclasses.replace(tconfigs.reduced(tconfigs.get_config(arch)), compute_dtype=dtype)


_PARAMS = {}


def _ref_params(arch):
    """(jax params, numpy params) of the reduced ``arch``, made once."""
    if arch not in _PARAMS:
        params = rbuild(_cfg(arch)).init(jax.random.PRNGKey(0))
        _PARAMS[arch] = params, jax.tree.map(np.asarray, params)
    return _PARAMS[arch]


def _pair(arch):
    tm = tbuild(_tcfg(arch), device="cpu")
    tm.load_state_dict(convert.decoder_params_from_reference(tm.cfg, _ref_params(arch)[1]))
    return rbuild(_cfg(arch)), tm


def _tensors(tree):
    return tcm.map_tree(lambda _, a: torch.tensor(np.asarray(a)), tree)


def _layer(stacked, i=0):
    return tcm.map_tree(lambda _, a: a[i], stacked)


def _prompts(cfg, seed=1, b=B, t=T):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def _normals(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _caches_close(rc, tc):
    """Every leaf of two cache trees: float leaves within ``CACHE``,
    integer leaves (write positions, ``enc_len``) equal."""
    ref = dict(tcm.iter_leaves(jax.tree.map(np.asarray, rc)))
    port = dict(tcm.iter_leaves(tc))
    assert sorted(ref) == sorted(port)
    for name, x in ref.items():
        if port[name].is_floating_point():
            _close(x, port[name], **CACHE)
        else:
            np.testing.assert_array_equal(x, port[name].numpy(), err_msg=name)


# ----------------------------------------------------------------------
# the attention options
# ----------------------------------------------------------------------
# (q_positions, kv_limit, kv_valid rows, q_chunk, k_chunk) of
# _sdpa_chunked on [2, 12, 4, 16] queries and 24 keys: not causal in
# 4 x 8 blocks and in one block, a cache limit alone and with causal
# positions, a key mask shared by the batch ([1, S]) and one per row
# ([B, S], in blocks that divide neither length, one row's first block
# all masked), and every option at once
SDPA_CASES = {
    "not causal": (None, None, None, 4, 8),
    "not causal, one block": (None, None, None, 512, 1024),
    "kv_limit": (None, 17, None, 4, 8),
    "causal and kv_limit": (np.arange(12, 24), 20, None, 4, 8),
    "kv_valid [1, S]": (None, None, 1, 4, 8),
    "kv_valid [B, S]": (None, None, 2, 5, 7),
    "everything": (np.arange(12, 24), 22, 2, 4, 8),
}


def _kv_valid(rows, s=24):
    valid = np.random.default_rng(9).random((rows, s)) < 0.6
    if rows > 1:
        valid[1, :8] = False  # row 1's first 8-key block sees nothing
    return valid


@pytest.mark.parametrize("case", SDPA_CASES)
def test_sdpa_chunked_options_against_the_reference_and_naive(case):
    qpos, limit, rows, qc, kc = SDPA_CASES[case]
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    valid = None if rows is None else _kv_valid(rows)
    opt = lambda f: dict(q_positions=None if qpos is None else f(qpos),  # noqa: E731
                         kv_limit=limit, kv_valid=None if valid is None else f(valid))
    ref = rat._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                            q_chunk=qc, k_chunk=kc, **opt(jnp.asarray))
    port = tat._sdpa_chunked(torch.tensor(q), torch.tensor(k), torch.tensor(v), 0.25,
                             q_chunk=qc, k_chunk=kc, **opt(torch.tensor))
    _close(ref, port, **F32)
    mask = np.ones((1, 12, 24), bool)
    if qpos is not None:
        mask = mask & (np.arange(24)[None, None, :] <= qpos[None, :, None])
    if limit is not None:
        mask = mask & (np.arange(24) < limit)
    if valid is not None:
        mask = mask & valid[:, None, :]
    naive = tat._sdpa_naive(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                            torch.tensor(mask), 0.25)
    _close(naive, port, **F32)


def test_gqa_params_cross_blocks_have_no_bias():
    cfg = dataclasses.replace(_cfg(VLM), qkv_bias=True)
    tcfg = dataclasses.replace(_tcfg(VLM), qkv_bias=True)
    for cross in (False, True):
        ref, port = rat.gqa_params(cfg, cross=cross), tat.gqa_params(tcfg, cross=cross)
        assert {k: v.shape for k, v in port.items()} == {k: v.shape for k, v in ref.items()}
    assert "bq" in tat.gqa_params(tcfg) and "bq" not in tat.gqa_params(tcfg, cross=True)
    assert "bq" not in tat.gqa_params(_tcfg(VLM))


# (kv_x, causal, use_rope, kv_valid ndim, qkv_bias) of gqa_attention
# without a cache: the encoder's non-causal self-attention, the
# decoder's cross-attention with and without a key mask ([Tk] and
# [B, Tk]), a causal cross-attention with RoPE (k turned at arange(Tk)),
# and a biased non-causal self-attention with a key mask
GQA_CASES = {
    "self, not causal": (False, False, True, 0, False),
    "cross": (True, False, False, 0, False),
    "cross, kv_valid [Tk]": (True, False, False, 1, False),
    "cross, kv_valid [B, Tk]": (True, False, False, 2, False),
    "cross, causal, rope": (True, True, True, 0, False),
    "self, bias, kv_valid": (False, False, True, 2, True),
}


@pytest.mark.parametrize("impl", ["chunked", "naive"])
@pytest.mark.parametrize("case", GQA_CASES)
def test_gqa_attention_options(case, impl):
    cross, causal, rope, vdim, bias = GQA_CASES[case]
    cfg, tcfg = _cfg(ENCDEC), _tcfg(ENCDEC)
    p = dict(_layer(_ref_params(ENCDEC)[1]["dec_layers"])["cross_attn" if cross else "self_attn"])
    if bias:
        rng = np.random.default_rng(10)
        p.update({n: rng.normal(size=p[w].shape[1:]).astype(np.float32)
                  for n, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv"))})
    x = _normals(5, B, T, cfg.d_model)
    tk = TE if cross else T
    src = _normals(6, B, tk, cfg.d_model) if cross else None
    valid = None
    if vdim:
        valid = np.random.default_rng(7).random((B, tk) if vdim == 2 else (tk,)) < 0.7
        valid[..., 0] = True
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    opt = dict(causal=causal, use_rope=rope, impl=impl)
    ref, _ = rat.gqa_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos), cfg,
                               kv_x=None if src is None else jnp.asarray(src),
                               kv_valid=None if valid is None else jnp.asarray(valid), **opt)
    port, cache = tat.gqa_attention(_tensors(p), torch.tensor(x), torch.tensor(pos), tcfg,
                                    kv_x=None if src is None else torch.tensor(src),
                                    kv_valid=valid, **opt)
    assert cache is None
    _close(ref, port, **F32)


def test_gqa_attention_with_cache_without_rope():
    """A cache write without RoPE (``use_rope=False``): the stored keys
    are the unturned projections, as the reference stores them."""
    cfg, tcfg = _cfg(ENCDEC), _tcfg(ENCDEC)
    p = _layer(_ref_params(ENCDEC)[1]["dec_layers"])["self_attn"]
    x = _normals(8, B, T, cfg.d_model)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    spec = rat.gqa_cache_spec(cfg, B, T + 1)
    rc = {k: jnp.zeros(s.shape, s.dtype) for k, s in spec.items()}
    tc = {k: torch.zeros(s.shape, dtype=s.dtype)
          for k, s in tat.gqa_cache_spec(tcfg, B, T + 1).items()}
    ref, rc = rat.gqa_attention(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(pos),
                                cfg, cache=rc, use_rope=False)
    port, tc = tat.gqa_attention(_tensors(p), torch.tensor(x), torch.tensor(pos), tcfg, cache=tc,
                                 use_rope=False)
    _close(ref, port, **F32)
    _caches_close(rc, tc)


# ----------------------------------------------------------------------
# the encoder-decoder, module by module
# ----------------------------------------------------------------------
def test_encode_against_the_reference():
    cfg, tcfg = _cfg(ENCDEC), _tcfg(ENCDEC)
    frames = _normals(11, B, TE, cfg.d_model)
    ref = jax.jit(lambda p, f: rlm.encode(cfg, p, f))(_ref_params(ENCDEC)[0], frames)
    port = tlm.encode(tcfg, _tensors(_ref_params(ENCDEC)[1]), frames)
    assert tuple(port.shape) == (B, TE, cfg.d_model) and port.dtype == torch.float32
    _close(ref, port, **F32)


def test_dec_block_apply_against_the_reference():
    """Decoder block 0 without a cache, against a padded ``enc_out`` whose
    last keys ``enc_valid`` masks, and with a cache at idx 0."""
    cfg, tcfg = _cfg(ENCDEC), _tcfg(ENCDEC)
    pl = _layer(_ref_params(ENCDEC)[1]["dec_layers"])
    x = _normals(12, B, T, cfg.d_model)
    enc = _normals(13, B, TE, cfg.d_model)
    pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32)
    valid = np.arange(TE) < TE - 3
    jpl = jax.tree.map(jnp.asarray, pl)
    for ev in (None, valid):
        ref, _ = rlm._dec_block_apply(cfg, jpl, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(enc),
                                      None, None if ev is None else jnp.asarray(ev))
        port, _ = tlm._dec_block_apply(tcfg, _tensors(pl), torch.tensor(x), torch.tensor(pos),
                                       torch.tensor(enc), None, None if ev is None else torch.tensor(ev))
        _close(ref, port, **F32)
    spec = rat.gqa_cache_spec(cfg, B, T + 2)
    rc = {k: jnp.zeros(s.shape, s.dtype) for k, s in spec.items()}
    tc = {k: torch.zeros(s.shape, dtype=s.dtype)
          for k, s in tat.gqa_cache_spec(tcfg, B, T + 2).items()}
    ref, rc = rlm._dec_block_apply(cfg, jpl, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(enc), rc,
                                   jnp.asarray(valid))
    port, tc = tlm._dec_block_apply(tcfg, _tensors(pl), torch.tensor(x), torch.tensor(pos),
                                    torch.tensor(enc), tc, torch.tensor(valid))
    _close(ref, port, **F32)
    _caches_close(rc, tc)


@pytest.mark.parametrize("enc_len", [None, TE - 4])
def test_decode_stack_against_the_reference(enc_len):
    cfg, tcfg = _cfg(ENCDEC), _tcfg(ENCDEC)
    tokens = _prompts(cfg, seed=14)
    enc = _normals(15, B, TE, cfg.d_model)
    ref, _ = jax.jit(lambda p, t, e: rlm.decode_stack(cfg, p, t, e, enc_len=enc_len))(
        _ref_params(ENCDEC)[0], tokens, enc)
    port, caches = tlm.decode_stack(tcfg, _tensors(_ref_params(ENCDEC)[1]), tokens,
                                    torch.tensor(enc), enc_len=enc_len)
    assert caches is None and tuple(port.shape) == (B, T, tcfg.padded_vocab)
    _close(ref, port, **F32)
    if enc_len is not None:  # the masked frames do not reach the logits
        moved = enc.copy()
        moved[:, enc_len:] = 7.0
        again, _ = tlm.decode_stack(tcfg, _tensors(_ref_params(ENCDEC)[1]), tokens,
                                    torch.tensor(moved), enc_len=enc_len)
        torch.testing.assert_close(again, port, rtol=0, atol=0)


# ----------------------------------------------------------------------
# the whole models
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", [VLM, ENCDEC])
def test_parameter_tree_names_and_dtypes_match_the_reference(arch):
    ref = _ref_params(arch)[1]
    tm = tbuild(tconfigs.reduced(tconfigs.get_config(arch)), device="cpu")
    assert {n: tuple(p.shape) for n, p in tm.state_dict().items()} == {
        n: tuple(x.shape) for n, x in tcm.iter_leaves(ref)}
    assert tcm.count_params(tm.abstract_params()) == sum(x.size for _, x in tcm.iter_leaves(ref))
    sd = tm.state_dict()
    assert sd["lm_head"].dtype == torch.float32
    assert all(v.dtype == torch.bfloat16 for k, v in sd.items() if k != "lm_head")
    if arch == ENCDEC:
        assert tm.hidden_step is None and tm.head_matrix is None
        assert "dec_layers.cross_attn.wk" in sd and "enc_norm" in sd


def test_encdec_prefill_decode_and_caches_at_float32():
    """The encdec ``Model``: prefill encodes the frames and writes the
    decoder's first tokens, the caches hold ``enc_out`` padded to their
    length (bfloat16) and ``enc_len``; then greedy decode steps.  Each
    step also runs from the reference's caches carried across."""
    rm, tm = _pair(ENCDEC)
    params = _ref_params(ENCDEC)[0]
    frames = _normals(16, B, TE, rm.cfg.d_model)
    tokens = _prompts(rm.cfg, seed=17, t=2)
    max_len = TE + GEN + 1
    rc, tc = rm.init_cache(B, max_len), tm.init_cache(B, max_len)
    assert (tc["enc_out"].shape, tc["enc_out"].dtype) == ((B, max_len, rm.cfg.d_model), torch.bfloat16)
    assert (tc["enc_len"].shape, tc["enc_len"].dtype) == ((), torch.int32)
    rl, rc = jax.jit(rm.prefill)(params, {"frames": frames, "tokens": tokens}, rc)
    before = tcm.map_tree(lambda _, c: c.clone(), tc)
    tl, tc2 = tm.prefill({"frames": frames, "tokens": tokens}, tc)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(tcm.iter_leaves(tc),
                                                         tcm.iter_leaves(before)))
    tc = tc2
    assert tuple(tl.shape) == (B, 1, tm.cfg.padded_vocab)
    _close(rl, tl, **F32)
    _caches_close(rc, tc)
    assert int(tc["enc_len"]) == TE and not bool(tc["enc_out"][:, TE:].any())
    step = jax.jit(rm.decode_step)
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    for i in range(GEN):
        pos = np.full((B, 1), TE + i, np.int32)
        carried = convert.decoder_cache_from_reference(tm.cfg, jax.tree.map(np.asarray, rc))
        rl, rc = step(params, tok[:, None], rc, pos)
        tl, tc = tm.decode_step(tok[:, None], tc, pos)
        _close(rl, tl, **F32)
        _caches_close(rc, tc)
        cl, _ = tm.decode_step(tok[:, None], carried, pos)
        _close(rl, cl, **F32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(), np.asarray(rl[:, -1].argmax(-1)))
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    assert int(tc["layers"]["idx"][0]) == 2 + GEN


def test_encdec_forward_against_the_reference():
    rm, tm = _pair(ENCDEC)
    batch = {"frames": _normals(18, B, TE, rm.cfg.d_model), "tokens": _prompts(rm.cfg, seed=19)}
    _close(jax.jit(rm.forward)(_ref_params(ENCDEC)[0], batch), tm(batch), **F32)


def _patches(cfg, seed=20):
    return _normals(seed, B, cfg.frontend_len, cfg.d_model)


def test_vlm_forward_with_patches_against_the_reference():
    rm, tm = _pair(VLM)
    params = _ref_params(VLM)[0]
    batch = {"patches": _patches(rm.cfg), "tokens": _prompts(rm.cfg, seed=21)}
    ref = jax.jit(lambda p, b: rlm.decoder_forward(rm.cfg, p, b)[0])(params, batch)
    port = tlm.decoder_forward(tm.cfg, tm.params(), batch)[0]
    assert tuple(port.shape) == (B, rm.cfg.frontend_len + T, tm.cfg.padded_vocab)
    _close(ref, port, **F32)
    _close(jax.jit(rm.forward)(params, batch), tm(batch), **F32)
    # without patches the vlm is the plain decoder
    _close(jax.jit(rm.forward)(params, {"tokens": batch["tokens"]}),
           tm({"tokens": torch.tensor(batch["tokens"])}), **F32)


def test_vlm_prefill_with_patches_then_decode_hidden_step_and_head():
    rm, tm = _pair(VLM)
    params = _ref_params(VLM)[0]
    npatch = rm.cfg.frontend_len
    batch = {"patches": _patches(rm.cfg, seed=22), "tokens": _prompts(rm.cfg, seed=23)}
    max_len = npatch + T + GEN + 1
    rl, rc = jax.jit(rm.prefill)(params, batch, rm.init_cache(B, max_len))
    tl, tc = tm.prefill({"patches": torch.tensor(batch["patches"]), "tokens": batch["tokens"]},
                        tm.init_cache(B, max_len))
    assert tuple(tl.shape) == (B, 1, tm.cfg.padded_vocab)
    _close(rl, tl, **F32)
    _caches_close(rc, tc)
    assert int(tc["layers"]["idx"][0]) == npatch + T
    tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    step = jax.jit(rm.decode_step)
    for i in range(GEN):
        pos = np.full((B, 1), npatch + T + i, np.int32)
        rl, rc = step(params, tok[:, None], rc, pos)
        tl, tc = tm.decode_step(tok[:, None], tc, pos)
        _close(rl, tl, **F32)
        _caches_close(rc, tc)
        tok = np.asarray(jnp.argmax(rl[:, -1], -1)).astype(np.int32)
    pos = np.full((B, 1), npatch + T + GEN, np.int32)
    rh, _ = jax.jit(rm.hidden_step)(params, tok[:, None], rc, pos)
    carried = convert.decoder_cache_from_reference(tm.cfg, jax.tree.map(np.asarray, rc))
    th, _ = tm.hidden_step(tok[:, None], carried, pos)
    assert tuple(th.shape) == (B, 1, tm.cfg.d_model)
    _close(rh, th, **F32)
    np.testing.assert_array_equal(np.asarray(rm.head_matrix(params)), tm.head_matrix().numpy())


PORTED = [a for a in ARCH_NAMES if get_config(a).family in tlm.PORTED_FAMILIES]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", PORTED)
def test_batch_spec_matches_the_reference(arch, shape):
    ref = rbuild(get_config(arch)).batch_spec(SHAPES[shape])
    port = treg.batch_spec(tconfigs.get_config(arch), tconfigs.SHAPES[shape])
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()} == {
        k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in port.items()}


def test_converters_refuse_foreign_encdec_trees():
    cfg, ref = _tcfg(ENCDEC), _ref_params(ENCDEC)[1]
    with pytest.raises(ValueError, match="missing.*enc_norm"):
        convert.decoder_params_from_reference(cfg, {k: v for k, v in ref.items() if k != "enc_norm"})
    dec = dict(ref["dec_layers"], cross_attn=dict(ref["dec_layers"]["cross_attn"],
                                                  bq=np.zeros((2, 64), np.float32)))
    with pytest.raises(ValueError, match="unknown.*dec_layers.cross_attn.bq"):
        convert.decoder_params_from_reference(cfg, dict(ref, dec_layers=dec))
    dec = dict(ref["dec_layers"], cross_attn=dict(ref["dec_layers"]["cross_attn"],
                                                  wk=np.zeros((2, 64, 32), np.float32)))
    with pytest.raises(ValueError, match="dec_layers.cross_attn.wk has shape"):
        convert.decoder_params_from_reference(cfg, dict(ref, dec_layers=dec))
    with pytest.raises(ValueError, match="unknown.*enc_layers"):  # an encdec tree for a vlm
        convert.decoder_params_from_reference(_tcfg(VLM), ref)
    caches = jax.tree.map(np.asarray, rbuild(_cfg(ENCDEC)).init_cache(B, 6))
    with pytest.raises(ValueError, match="missing.*enc_len"):
        convert.decoder_cache_from_reference(cfg, {k: v for k, v in caches.items() if k != "enc_len"})
    with pytest.raises(ValueError, match="enc_out has shape"):
        convert.decoder_cache_from_reference(cfg, dict(caches, enc_out=caches["enc_out"][:, :4]))
    with pytest.raises(ValueError, match="unknown.*enc_out"):  # encdec caches for a vlm
        convert.decoder_cache_from_reference(_tcfg(VLM), caches)


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------
def test_vlm_private_head_gives_the_reference_tokens_and_summary():
    """Both packages' ``_decode_private_head`` on the reduced InternVL2 at
    float32 compute, after a prefill of patches and prompts (decode
    positions from patches + prompt): the same greedy tokens and
    ``EngineReport.summary()``."""
    rm, tm = _pair(VLM)
    params = _ref_params(VLM)[0]
    npatch = rm.cfg.frontend_len
    args = argparse.Namespace(batch=2, prompt_len=npatch + T, gen_len=4, workers=16)
    max_len = args.prompt_len + args.gen_len
    batch = {"patches": _patches(rm.cfg, seed=24), "tokens": _prompts(rm.cfg, seed=0)}
    logits, cache = jax.jit(rm.prefill)(params, batch, rm.init_cache(args.batch, max_len))
    rtok = np.asarray(rserve.jnp_argmax(logits, rm.cfg.vocab_size))
    rsteps, rrep, rworst = rserve._decode_private_head(args, rm.cfg, rm, params, cache, rtok)
    logits, cache = tm.prefill(batch, tm.init_cache(args.batch, max_len))
    ttok = tserve.argmax_last(logits, tm.cfg.vocab_size)
    tsteps, trep, tworst = tserve._decode_private_head(args, tm.cfg, tm, cache, ttok)
    np.testing.assert_array_equal(ttok, rtok)
    assert tsteps == rsteps == args.gen_len - 1
    assert trep.summary() == rrep.summary() and trep.summary()["served"] == tsteps
    for t, r in zip(trep.requests, rrep.requests):
        np.testing.assert_array_equal(t.y[: args.batch].argmax(-1), r.y[: args.batch].argmax(-1))
        np.testing.assert_allclose(t.x, r.x, **F32)
        assert (t.launch, t.completion, t.replay) == (r.launch, r.completion, r.replay)


def test_encdec_launcher_greedy_decode_gives_the_reference_tokens(monkeypatch, capsys):
    """The port's launcher in process on the reduced SeamlessM4T at
    float32 compute, on the reference's weights: its prompts and frames
    (``default_rng(0)``: prompts, then frames) through prefill and
    greedy decode give the tokens the reference's model gives on the
    same draws through the reference launcher's loop."""
    rm, tm = _pair(ENCDEC)
    tokens = []
    monkeypatch.setattr(tserve, "reduce_cfg", lambda cfg: tm.cfg)
    monkeypatch.setattr(tserve, "build_model", lambda cfg, seed, device: tm)
    argmax = tserve.argmax_last
    monkeypatch.setattr(tserve, "argmax_last",
                        lambda logits, vocab: tokens.append(argmax(logits, vocab)) or tokens[-1])
    tserve.main(["--arch", ENCDEC, "--reduced", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert f"serving {ENCDEC} on cpu" in out
    assert "prefill:" in out and "for 8 x 2 tokens" in out and "ms/step (batch 2)" in out

    params = _ref_params(ENCDEC)[0]
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, rm.cfg.vocab_size, (2, 8)).astype(np.int32)
    frames = rng.normal(size=(2, 8, rm.cfg.d_model)).astype(np.float32)
    logits, cache = jax.jit(rm.prefill)(params, {"frames": frames, "tokens": prompts[:, :1]},
                                        rm.init_cache(2, 12))
    want = [np.asarray(rserve.jnp_argmax(logits, rm.cfg.vocab_size))]
    step = jax.jit(rm.decode_step)
    for i in range(3):
        logits, cache = step(params, want[-1][:, None], cache, np.full((2, 1), 8 + i, np.int32))
        want.append(np.asarray(rserve.jnp_argmax(logits, rm.cfg.vocab_size)))
    assert len(tokens) == len(want) == 4
    for t, w in zip(tokens, want):
        np.testing.assert_array_equal(t, w)


def test_encdec_private_head_refused_as_the_reference_after_the_prefill(monkeypatch, capsys):
    rm = rbuild(_cfg(ENCDEC))
    args = argparse.Namespace(batch=2, prompt_len=8, gen_len=4, workers=16)
    with pytest.raises(SystemExit) as ref:
        rserve._decode_private_head(args, rm.cfg, rm, None, None, None)
    prefills = []
    prefill = treg.EncDecModel.prefill
    monkeypatch.setattr(treg.EncDecModel, "prefill",
                        lambda self, b, c: prefills.append(1) or prefill(self, b, c))
    with pytest.raises(SystemExit) as port:
        tserve.main(["--arch", ENCDEC, "--reduced", "--private-head", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    assert str(port.value) == str(ref.value)
    assert "does not expose one" in str(port.value) and "'encdec'" in str(port.value)
    assert prefills == [1]
    assert f"serving {ENCDEC} on cpu" in capsys.readouterr().out
