"""``chip_smoke.py`` rehearsed on the CPU: every phase at tiny sizes (the
kernel in interpret mode) through its test-only ``--rehearse`` switch, and
the refusals the driver relies on."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=ROOT, devices=1):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=900)


def test_rehearsal_runs_every_phase():
    proc = _run(["--rehearse"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("card:")
    phases = [json.loads(l)["phase"] for l in lines if l.startswith('{"phase"')]
    assert phases == ["langevin", "kernel", "dit_train", "dit_generate", "pcd"]
    last = json.loads(lines[-1])
    assert last == {"ok": True, "device": {"platform": "cpu", "kind": "cpu", "count": 1}}


def test_four_device_rehearsal():
    proc = _run(["--rehearse", "--four"], devices=4)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    four = json.loads(lines[-2])
    assert four["phase"] == "four" and four["max_rel_diff"] <= four["tolerance_rel"]
    assert json.loads(lines[-1])["device"]["count"] == 4


def test_refuses_without_a_gpu():
    proc = _run([])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_refuses_outside_the_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["--rehearse"], cwd=str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
