"""The port's training launcher and its four examples, as a user runs them:
``python -m repro_torch.launch.train`` and ``examples/torch/*.py`` in
subprocesses on ``--device cpu``, against the JAX package's launcher and
examples where they print the same numbers.

* The launcher trains and auto-resumes, as ``test_train_driver_with_resume``
  has the reference's do; and it resumes from a checkpoint that the
  reference's launcher wrote: restored exactly (its parameters and
  moments saved back bit for bit), after which its losses are the
  reference launcher's from the same checkpoint within 2**-5 relative
  (bfloat16 compute: each framework rounds at its own points; observed
  equal to the 4 printed decimals).
* ``quickstart.py`` runs with its exact asserts; ``private_inference.py
  --ranks 8`` (8 spawned gloo ranks) prints the reference example's
  summary (replays, p95 latencies, end-to-end worst, deadline misses,
  relative error) on its 8 host devices, line for line;
  ``train_lm.py --profile tiny``'s loss falls; ``serve_lm.py`` serves a
  decoder and a recurrent arch.
"""
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from _subproc import subprocess_env

TIMEOUT = 400


def _run(args, **env):
    res = subprocess.run([sys.executable] + args, capture_output=True, text=True,
                         timeout=TIMEOUT, env=subprocess_env(**env), cwd=".")
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def _losses(out: str) -> dict:
    return {int(m[1]): float(m[2]) for m in re.finditer(r"step\s+(\d+) loss ([0-9.]+)", out)}


ARGS = ["--arch", "minicpm-2b", "--reduced", "--seq-len", "32", "--global-batch", "2",
        "--mesh", "1x1", "--ckpt-every", "3"]
LAUNCH = ["-m", "repro_torch.launch.train"] + ARGS


def test_train_launcher_with_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = _run(LAUNCH + ["--steps", "6", "--ckpt-dir", ckpt, "--microbatch-seqs", "2",
                         "--device", "cpu"])
    assert "training minicpm-2b on cpu" in out and "loss" in out and "done" in out
    out2 = _run(LAUNCH + ["--steps", "8", "--ckpt-dir", ckpt, "--device", "cpu"])
    assert "auto-resumed from step 6" in out2 and "step     7 loss" in out2


def _arrays(ckpt_dir, step):
    with np.load(ckpt_dir / f"step_{step:010d}" / "arrays.npz") as npz:
        return {k: npz[k] for k in npz.files}


def test_train_launcher_resumes_the_references_checkpoint(tmp_path, capsys):
    """``repro.launch.train`` writes checkpoints at steps 3 and 6.  The
    port's launcher, given only the step-3 one and ``--steps 3``, restores
    it into its model and saves it back at its end without a step: every
    parameter and moment equals the reference's bit for bit (its seed-0
    init does not).  Given ``--steps 6``, it trains steps 3-5, whose
    losses equal the reference launcher's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.common import iter_leaves

    ref_dir, port_dir, back_dir = tmp_path / "ref", tmp_path / "port", tmp_path / "back"
    ref_out = _run(["-m", "repro.launch.train"] + ARGS + ["--steps", "6", "--ckpt-dir", str(ref_dir),
                                                         "--log-every", "1"])
    want = _arrays(ref_dir, 3)
    shutil.copytree(ref_dir / "step_0000000003", back_dir / "step_0000000003")
    train.main(ARGS + ["--steps", "3", "--ckpt-dir", str(back_dir), "--device", "cpu"])
    assert "auto-resumed from step 3" in capsys.readouterr().out
    got = _arrays(back_dir, 3)
    assert sorted(got) == sorted(want) and int(got["opt/step"]) == 3
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(got[key], arr, err_msg=key)
    init = build_model(reduced(get_config("minicpm-2b")), seed=0, device="cpu", train=True)
    assert not all(np.array_equal(p.detach().numpy(), want[f"params/{name.replace('.', '/')}"])
                   for name, p in iter_leaves(init.params()))

    port_dir.mkdir()
    shutil.copytree(ref_dir / "step_0000000003", port_dir / "step_0000000003")
    port_out = _run(LAUNCH + ["--steps", "6", "--ckpt-dir", str(port_dir), "--log-every", "1",
                              "--device", "cpu"])
    assert "auto-resumed from step 3" in port_out
    ref, port = _losses(ref_out), _losses(port_out)
    assert sorted(port) == [3, 4, 5]
    for step in port:
        assert port[step] == pytest.approx(ref[step], rel=2.0**-5), (step, port, ref)


def test_train_launcher_refuses_a_mesh_of_several_devices():
    from repro_torch.launch import train

    with pytest.raises(NotImplementedError, match="ROADMAP 13b"):
        train.main(["--arch", "minicpm-2b", "--reduced", "--mesh", "2x2", "--device", "cpu"])


def test_quickstart_runs_with_its_asserts():
    out = _run(["examples/torch/quickstart.py", "--device", "cpu"])
    assert "AGE-CMPC      : 17 workers (lambda* = 2)" in out
    assert "exact result verified" in out and "batched secure_matmul" in out


def _summary(out: str) -> list:
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines) if "clients through" in line)
    return lines[start:start + 3]


def test_private_inference_on_8_ranks_prints_the_references_summary():
    port = subprocess.Popen([sys.executable, "examples/torch/private_inference.py", "--device",
                             "cpu", "--ranks", "8"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=subprocess_env(), cwd=".")
    ref = subprocess.run([sys.executable, "examples/private_inference.py"], capture_output=True,
                         text=True, timeout=TIMEOUT, cwd=".",
                         env=subprocess_env(XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    port_out, port_err = port.communicate(timeout=TIMEOUT)
    assert ref.returncode == 0, ref.stdout + ref.stderr
    assert port.returncode == 0, port_out + port_err
    assert "devices as workers: 8" in ref.stdout and "ranks as workers: 8 (cpu)" in port_out
    assert _summary(port_out) == _summary(ref.stdout)


def test_train_lm_tiny_loss_falls(tmp_path):
    out = _run(["examples/torch/train_lm.py", "--device", "cpu", "--steps", "40",
                "--seq-len", "128", "--ckpt-dir", str(tmp_path / "ckpt")])
    losses = [float(m[1]) for m in re.finditer(r"loss ([0-9.]+)", out)]
    assert len(losses) == 5, out
    assert losses[-1] < losses[0] - 0.1, losses
    assert "done; checkpoints in" in out and (tmp_path / "ckpt" / "step_0000000040").is_dir()


@pytest.mark.parametrize("arch", ["minicpm-2b", "zamba2-2.7b"])
def test_serve_lm_samples(arch):
    out = _run(["examples/torch/serve_lm.py", "--arch", arch, "--device", "cpu",
                "--gen-len", "8"])
    assert f"arch={arch}" in out and "ms/step" in out
    assert re.search(r"sampled token ids \(seq 0\): \[[ 0-9]+\]", out), out
