"""Both launchers under ``torchrun`` on 4 gloo CPU ranks (2x2) for the
families that joined the mesh: the vlm's private head served from the
sharded trunk, and Zamba2 (hybrid) trained on 2x2 and resumed on 1x1.
Each run is a subprocess, as ``test_torch_mesh.py``'s launcher tests."""
import subprocess
import sys

TIMEOUT = 240


def _env():
    from _subproc import subprocess_env

    return subprocess_env(OMP_NUM_THREADS="1")


def _torchrun(args):
    return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", "4", *args], capture_output=True, text=True,
                          timeout=TIMEOUT, env=_env(), cwd=".")


def _one(args):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=TIMEOUT, env=_env(), cwd=".")


def test_serve_launcher_serves_the_vlm_private_head_on_2x2_as_one_device():
    """InternVL2's trunk on 2x2 (``hidden_step`` under the decode bundle's
    rules), its head gathered on every rank into the same
    ``ServingEngine``: the replays and simulated latencies of the
    engine's summary equal the one-device run's."""
    common = ["-m", "repro_torch.launch.serve", "--arch", "internvl2-26b", "--reduced",
              "--private-head", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
              "--gen-len", "4"]
    one = _one(common)
    assert one.returncode == 0, one.stdout + one.stderr
    res = _torchrun([*common, "--mesh", "2x2"])
    assert res.returncode == 0, res.stdout + res.stderr
    lines, want = res.stdout.splitlines(), one.stdout.splitlines()
    assert lines[0] == "serving internvl2-26b on mesh{'data': 2, 'model': 2} over 4 devices"
    assert len(lines) == len(want) == 4
    # the logit error depends on the bfloat16 trunk's roundings, which the shards change
    assert lines[3].split(", max |logit err|")[0] == want[3].split(", max |logit err|")[0]


def test_serve_launcher_decodes_zamba2_on_2x2():
    res = _torchrun(["-m", "repro_torch.launch.serve", "--arch", "zamba2-2.7b", "--reduced",
                     "--device", "cpu", "--mesh", "2x2", "--batch", "2", "--prompt-len", "8",
                     "--gen-len", "4"])
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == "serving zamba2-2.7b on mesh{'data': 2, 'model': 2} over 4 devices"
    assert lines[1].startswith("prefill: ") and lines[2].startswith("decode : ")
    assert len(lines) == 3  # rank 0 alone prints


def test_train_launcher_trains_zamba2_on_2x2_and_resumes_on_1x1(tmp_path):
    common = ["-m", "repro_torch.launch.train", "--arch", "zamba2-2.7b", "--reduced",
              "--seq-len", "16", "--global-batch", "8", "--log-every", "1", "--ckpt-dir",
              str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    res = _torchrun([*common, "--steps", "2", "--mesh", "2x2"])
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    assert lines[0] == ("training zamba2-2.7b on mesh{'data': 2, 'model': 2} over 4 devices; "
                        "schedule=cosine")
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "0"], ["step", "1"]]
    assert lines[-1] == "done" and len(lines) == 4  # rank 0 alone prints
    one = _one([*common, "--steps", "4", "--mesh", "1x1"])
    assert one.returncode == 0, one.stdout + one.stderr
    lines = one.stdout.splitlines()
    assert lines[0] == "training zamba2-2.7b on cpu (one device); schedule=cosine"
    assert lines[1] == "auto-resumed from step 2"
    assert [ln.split()[:2] for ln in lines[2:4]] == [["step", "2"], ["step", "3"]]
    assert lines[-1] == "done"
