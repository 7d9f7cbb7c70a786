"""The port's serving launcher against the JAX package's.

``repro.launch.serve._decode_private_head`` and the port's, at the
reduced Mistral-NeMo-12B width with float32 compute, on the same
weights (the reference's, carried with ``convert``), prompts
(``default_rng(0)``, as both launchers draw them) and worker traces
(each package samples ``sample_trace(16, ShiftedExponential(0.1, 0.5),
seed=s, net_scale=0.3)``, s = 0..3, with the same numpy draws): the
greedy tokens are equal, ``EngineReport.summary()`` is exactly equal,
and every served logit is within the quantisation bound of ``x @ W``
(``head_error_bound`` at the scale ``choose_scales`` picked).  The
hidden rows the two trunks send differ by the float32 tolerance of
``tests/test_torch_models.py``.  Then the port's command line, in a
subprocess and in process.
"""
import argparse
import dataclasses
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _subproc import subprocess_env
from repro.configs import get_config, reduced
from repro.launch import serve as rserve
from repro.models import build_model as rbuild
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.core import gf as tgf
from repro_torch.core import layers as tlayers
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as tbuild

ARCH = "mistral-nemo-12b"
ARGS = argparse.Namespace(batch=2, prompt_len=8, gen_len=4, workers=16)
F32 = dict(rtol=1e-4, atol=2e-4)  # as tests/test_torch_models.py


def _tokens(report, batch, vocab):
    return [r.y[:batch, :vocab].argmax(-1) for r in report.requests]


@pytest.fixture(scope="module")
def decoded():
    """(reference, port): (first token, steps, report, worst, head matrix)."""
    rcfg = dataclasses.replace(reduced(get_config(ARCH)), compute_dtype="float32")
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_config(ARCH)), compute_dtype="float32")
    max_len = ARGS.prompt_len + ARGS.gen_len
    prompts = np.random.default_rng(0).integers(
        0, rcfg.vocab_size, (ARGS.batch, ARGS.prompt_len)).astype(np.int32)

    rm = rbuild(rcfg)
    params = rm.init(jax.random.PRNGKey(0))
    logits, cache = jax.jit(rm.prefill)(params, {"tokens": prompts}, rm.init_cache(ARGS.batch, max_len))
    rtok = np.asarray(rserve.jnp_argmax(logits, rcfg.vocab_size))
    ref = (rtok, *rserve._decode_private_head(ARGS, rcfg, rm, params, cache, rtok),
           np.asarray(rm.head_matrix(params), np.float64))

    tm = tbuild(tcfg, device="cpu")
    tm.load_state_dict(convert.decoder_params_from_reference(tcfg, jax.tree.map(np.asarray, params)))
    logits, cache = tm.prefill({"tokens": prompts}, tm.init_cache(ARGS.batch, max_len))
    ttok = tserve.argmax_last(logits, tcfg.vocab_size)
    port = (ttok, *tserve._decode_private_head(ARGS, tcfg, tm, cache, ttok),
            tm.head_matrix().numpy().astype(np.float64))
    return ref, port


def test_private_head_decode_gives_the_reference_tokens_and_summary(decoded):
    (rtok, rsteps, rrep, _, rw), (ttok, tsteps, trep, _, tw) = decoded
    np.testing.assert_array_equal(ttok, rtok)
    assert tsteps == rsteps == ARGS.gen_len - 1
    assert trep.summary() == rrep.summary()
    assert trep.summary()["served"] == ARGS.gen_len - 1
    np.testing.assert_array_equal(tw, rw)
    vocab = rw.shape[1]
    for t, r in zip(_tokens(trep, ARGS.batch, vocab), _tokens(rrep, ARGS.batch, vocab)):
        np.testing.assert_array_equal(t, r)
    for t, r in zip(trep.requests, rrep.requests):
        np.testing.assert_allclose(t.x, r.x, **F32)
        assert (t.launch, t.completion, t.replay) == (r.launch, r.completion, r.replay)


def test_private_head_logits_within_the_quantisation_bound(decoded):
    """Every served logit of either launcher is within the bound that
    follows from its request's scale; each launcher's ``worst`` is the
    largest such error, and below every request's bound."""
    p = tgf.Field().p
    for _, steps, report, worst, w in decoded:
        errors, bounds = [], []
        for r in report.requests:
            x = r.x[: ARGS.batch]
            s = tlayers.choose_scales(w.shape[0], float(np.abs(r.x).max() + 1e-9),
                                      float(np.abs(w).max() + 1e-9), p)
            errors.append(float(np.abs(r.y[: ARGS.batch] - x @ w).max()))
            bounds.append(tserve.head_error_bound(x, w, s))
            assert errors[-1] <= bounds[-1], (errors[-1], bounds[-1], s)
        assert len(errors) == steps
        assert worst == max(errors) <= min(bounds)


def test_launcher_command_line_private_head():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--reduced",
         "--private-head", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--gen-len", "4"],
        capture_output=True, text=True, timeout=300, env=subprocess_env(), cwd=".",
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "serving mistral-nemo-12b on cpu" in res.stdout
    assert "ms/step (batch 2)" in res.stdout
    assert "private head: 3 protocol replays over 3 steps on 16 workers" in res.stdout


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "yi-34b", "qwen2-72b"])
def test_launcher_greedy_decode_in_process(arch, capsys):
    tserve.main(["--arch", arch, "--reduced", "--mesh", "1x1", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "8", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert f"serving {arch} on cpu" in out
    assert "prefill:" in out and "ms/step (batch 2)" in out
    assert "private head" not in out


def test_launcher_refuses_what_is_not_ported():
    base = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len", "4", "--gen-len", "2"]
    with pytest.raises(NotImplementedError, match="ROADMAP 13b"):
        tserve.main(["--arch", ARCH, "--mesh", "2x4", *base])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--arch", ARCH, "--reduced"])
